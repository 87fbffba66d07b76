"""The reference's PRNG: ``jax.random``'s keyed threefry2x32 in torch.

The reference draws its parameters with ``jax.random`` under JAX's
defaults: the ``threefry2x32`` implementation with
``jax_threefry_partitionable`` on.  In that mode the random bits of an
element depend only on the key and the element's row-major index in the
whole array, so any block of a draw can be computed alone and equals the
same slice of the whole draw.  This module is the port's copy of the
parts of ``jax/_src/prng.py`` and ``jax/_src/random.py`` that the models
use:

* ``PRNGKey``, ``split`` and ``random_bits`` give JAX's keys and bits bit
  for bit;
* ``uniform`` and ``truncated_normal`` apply JAX's float transforms to
  those bits, and both are exact.  ``truncated_normal``'s inverse error
  function is Giles's single-precision polynomial, which XLA evaluates
  with each Horner step a fused multiply-add, its ``log1p`` is XLA's CPU
  ``log1p`` copied op by op (``log1p``), and the ``erf`` of its bounds is
  XLA's CPU ``erf`` (``erf``).  Every fused multiply-add goes through
  ``fma32``, rounded once and exactly, and every other op is one IEEE
  fp32 op, so the card and the CPU give JAX's bits.

A key is an ``int64`` tensor of shape ``(*batch, 2)`` holding two uint32
words; keys are small and live on the CPU.  A key with batch dims draws a
stack: slice ``[i]`` of the draw is the draw under key ``[i]``, as
``jax.vmap`` over keys gives it.

Every draw takes ``block=(offset, shape)``, a box of the whole (batched)
draw, and returns just that box, on ``device``.  It forms nothing larger
than the box: the work runs over slabs of at most ``SLAB`` elements
(``CPU_SLAB`` on the CPU), whose ``int64`` temporaries are the largest
tensors made.  All integer
arithmetic is on ``int64`` holding uint32 values, masked after every add
and shift, so it needs no unsigned type and no signed overflow, and the
card and the CPU give the same bits.
"""
from __future__ import annotations

import itertools
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

MASK = 0xFFFFFFFF
#: Largest number of elements one slab of a draw works on.
SLAB = 1 << 25
#: The same on the CPU: torch's grain size, up to which an element-wise op
#: runs on one thread.  A draw is ~200 element-wise passes, each too short
#: to gain from waking the thread pool.
CPU_SLAB = 1 << 15
#: ATen's grain size for transcendental ops (``sqrt``) on the CPU, which
#: run on the thread pool above it; ``_one_thread`` feeds them runs of
#: this length.
_VML_GRAIN = 2048

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Block = Tuple[Sequence[int], Sequence[int]]


# ------------------------------------------------------------ threefry ----
def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r).bitwise_and_(MASK).bitwise_or_(x >> (32 - r))


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The threefry-2x32 hash (20 rounds) of the counter pairs ``(x1, x2)``
    under the key ``(k1, k2)``; keys are ints or tensors that broadcast
    against the counters, all uint32 values in ``int64``."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]).bitwise_and_(MASK)
    x2 = (x2 + ks[1]).bitwise_and_(MASK)
    x1, x2 = torch.broadcast_tensors(x1, x2)
    x1, x2 = x1.contiguous(), x2.contiguous()
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1.add_(x2).bitwise_and_(MASK)
            x2 = _rotl(x2, r).bitwise_xor_(x1)
        x1.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x2.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(MASK)
    return x1, x2


# ---------------------------------------------------------------- keys ----
def PRNGKey(seed: int) -> torch.Tensor:
    """The key of a 32-bit ``seed``: ``[0, seed]``, as ``jax.random.PRNGKey``
    gives it with 64-bit types off (a negative seed wraps to uint32)."""
    seed = int(seed)
    if not -(1 << 31) <= seed <= MASK:
        raise ValueError(f"seed {seed} is not a 32-bit integer")
    return torch.tensor([0, seed & MASK], dtype=torch.int64)


def _as_key(key) -> torch.Tensor:
    key = torch.as_tensor(key).to(device="cpu", dtype=torch.int64)
    if key.ndim < 1 or key.shape[-1] != 2:
        raise ValueError(f"a key has shape (..., 2), got {tuple(key.shape)}")
    return key


def split(key, num: int = 2) -> torch.Tensor:
    """``num`` new keys from ``key`` (shape ``(*batch, num, 2)``), as
    ``jax.random.split`` in partitionable mode: key ``i`` is the hash of the
    counter pair ``(0, i)``."""
    key = _as_key(key)
    lo = torch.arange(num, dtype=torch.int64)
    y1, y2 = threefry2x32(key[..., 0:1], key[..., 1:2],
                          torch.zeros_like(lo), lo)
    return torch.stack([y1, y2], dim=-1)


# ---------------------------------------------------------------- bits ----
def _slabs(shape: Sequence[int], cap: int):
    """Boxes (offset, shape) that tile ``shape`` in row-major order, each of
    at most ``cap`` elements (a box spans whole trailing dims)."""
    shape = tuple(shape)
    if math.prod(shape) == 0:
        return
    if math.prod(shape) <= cap:
        yield (0,) * len(shape), shape
        return
    d = next(d for d in range(len(shape))
             if math.prod(shape[d + 1:]) <= cap)
    step = max(1, cap // math.prod(shape[d + 1:]))
    for lead in itertools.product(*(range(s) for s in shape[:d])):
        for j in range(0, shape[d], step):
            n = min(step, shape[d] - j)
            yield (lead + (j,) + (0,) * (len(shape) - d - 1),
                   (1,) * d + (n,) + shape[d + 1:])


def _bits(key: torch.Tensor, shape: Tuple[int, ...], offset, box,
          device: torch.device) -> torch.Tensor:
    """The bits of the box ``(offset, box)`` of the draw of ``shape`` under
    the (batched) ``key``: uint32 values in an ``int64`` tensor of shape
    ``box``."""
    nb = key.ndim - 1
    nd = len(shape)
    keys = key[tuple(slice(o, o + n) for o, n in zip(offset[:nb], box[:nb]))]
    if keys.numel() == 2:
        k1, k2 = (int(v) for v in keys.reshape(2))
    else:
        keys = keys.to(device)
        k1 = keys[..., 0].reshape(tuple(box[:nb]) + (1,) * nd)
        k2 = keys[..., 1].reshape(tuple(box[:nb]) + (1,) * nd)
    strides = [math.prod(shape[d + 1:]) for d in range(nd)]
    idx = torch.zeros((1,) * (nb + nd), dtype=torch.int64, device=device)
    for d in range(nd):
        o, n = offset[nb + d], box[nb + d]
        view = [1] * (nb + nd)
        view[nb + d] = n
        idx = idx + (torch.arange(o, o + n, dtype=torch.int64,
                                  device=device) * strides[d]).reshape(view)
    y1, y2 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return y1.bitwise_xor_(y2).expand(tuple(box))


def draw(key, shape: Sequence[int], dtype: torch.dtype,
         transform: Callable[[torch.Tensor], torch.Tensor], *,
         block: Optional[Block] = None,
         device: torch.device | str | None = None) -> torch.Tensor:
    """``transform`` of the random bits of a draw of ``shape`` under ``key``,
    in ``dtype`` on ``device`` (default: the CPU): the whole draw, of shape
    ``key.shape[:-1] + shape``, or its box ``block=(offset, shape)``.

    The box is filled slab by slab, so no tensor larger than the box or
    than ``SLAB`` elements is made; a box equals the same slice of the
    whole draw bit for bit.
    """
    key = _as_key(key)
    shape = tuple(int(s) for s in shape)
    full = tuple(key.shape[:-1]) + shape
    device = torch.device(device if device is not None else "cpu")
    if block is None:
        offset, box = (0,) * len(full), full
    else:
        offset, box = (tuple(int(v) for v in b) for b in block)
        if len(offset) != len(full) or len(box) != len(full) or any(
                o < 0 or n < 0 or o + n > s
                for o, n, s in zip(offset, box, full)):
            raise ValueError(f"block {block} is not a box of {full}")
    out = torch.empty(box, dtype=dtype, device=device)
    if device.type == "meta":
        return out
    cap = min(SLAB, CPU_SLAB) if device.type == "cpu" else SLAB
    for soff, sbox in _slabs(box, cap):
        bits = _bits(key, shape, tuple(o + s for o, s in zip(offset, soff)),
                     sbox, device)
        out[tuple(slice(s, s + n) for s, n in zip(soff, sbox))] = \
            transform(bits)
    return out


def random_bits(key, shape: Sequence[int] = (), *,
                block: Optional[Block] = None,
                device: torch.device | str | None = None) -> torch.Tensor:
    """32 random bits per element, as ``jax.random.bits(key, shape,
    jnp.uint32)`` (the two hash words xor-ed): uint32 values in ``int64``."""
    return draw(key, shape, torch.int64, lambda b: b, block=block,
                device=device)


# -------------------------------------------------------------- floats ----
def _f32(x) -> float:
    return float(np.float32(x))


def _bits32(*bits: int) -> Tuple[float, ...]:
    """The fp32 values of uint32 bit patterns."""
    return tuple(float(v) for v in np.array(bits, np.uint32).view(np.float32))


def fma32(a, b, c) -> torch.Tensor:
    """The fp32 fused multiply-add ``a·b + c``, rounded once, for results in
    fp32's normal range.  The operands are fp32 values: fp32 or fp64
    tensors or Python floats, ``a`` or ``b`` a tensor.

    The product of two fp32 values is exact in fp64.  The fp64 sum ``s`` is
    rounded to odd (where it is inexact and its last bit is even, it steps
    one fp64 ulp toward the exact sum, whose side the TwoSum error gives),
    and then to nearest fp32: rounding to odd with at least two more bits
    than the target keeps the one rounding exact.  Only an ``s`` on an fp32
    midpoint (its low 29 bits ``1 << 28``) rounds differently once made
    odd, so a call whose sums hold no midpoint skips that work, and the
    work runs on those sums alone."""
    if torch.is_tensor(b) and b.dtype == torch.float64:
        a, b = b, a
    if not torch.is_tensor(a):
        s = b.double().mul_(a)
    elif a.dtype == torch.float64:
        s = a.mul(b)
    else:
        s = a.double().mul_(b)
    s = s.add_(c)
    flat = s.view(-1)
    mid = (flat.view(torch.int32)[0::2] & 0x1FFFFFFF) == 0x10000000
    if bool(mid.any()):
        i = mid.nonzero().squeeze(1)
        p = _pick(a, s.shape, i) * _pick(b, s.shape, i)
        si, ci = flat[i], _pick(c, s.shape, i)
        z = si - p
        e = (p - (si - z)) + (ci - z)
        flat[i] = torch.where(e != 0, torch.nextafter(si, e * math.inf), si)
    return s.float()


def _pick(x, shape, i):
    """Elements ``i`` of ``x`` broadcast to ``shape`` and flattened, in
    fp64 (a Python float as it is)."""
    if not torch.is_tensor(x):
        return x
    return torch.broadcast_to(x, shape).reshape(-1)[i].double()


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0,
                      maxval: float = 1.0) -> torch.Tensor:
    """JAX's fp32 uniform of 32 random bits: the top 23 bits as the mantissa
    of a float in [1, 2), minus 1, scaled to [minval, maxval) and raised to
    ``minval``.  XLA fuses the scale and the shift into one multiply-add,
    rounded once; so is this one (``fma32``)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return fma32(f - 1.0, float(hi - lo), float(lo)).clamp_min_(float(lo))


#: The constants of XLA's CPU ``log1p`` (``xla.log1p.f32``), as fp32 bit
#: patterns.  Large branch, ``log(1 + x)`` by Cephes's ``logf``: the
#: smallest normal it clamps to, √½, the degree-8 polynomial as three
#: chains (``_LOGF_A``, ``_LOGF_B``, ``_LOGF_C``, highest power first),
#: the low and high parts of ln 2.
_LOGF_MIN, _LOGF_SQRTHALF = _bits32(0x00800000, 0x3F3504F3)
_LOGF_A = _bits32(0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A)
_LOGF_B = _bits32(0xBDFE5D4F, 0x3E11E9BF, 0xBE2AAE50)
_LOGF_C = _bits32(0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA)
_LN2_LO, _LN2_HI = _bits32(0xB95E8083, 0x3F318000)
#: Small branch, below √2 - 1 in magnitude: Cephes's rational
#: ``log1p(x) = x - x²/2 + x³·P(x)/Q(x)``, highest power first (Q's
#: leading coefficient is 1).
_LOG1P_SMALL = _bits32(0x3ED413CD)[0]
_LOG1P_P = _bits32(0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C,
                   0x4273CC76, 0x426473AD, 0x41A05101)
_LOG1P_Q = _bits32(0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3,
                   0x43586D8A, 0x42707982)


def _flush(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its subnormals flushed to zeros of their sign, as XLA's CPU
    code runs (denormals as zero, flushed to zero)."""
    return torch.where(x.abs() < _LOGF_MIN, x * 0.0, x)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + x)`` of fp32 ``x`` as XLA's CPU backend computes it, op for
    op: its ``xla.log1p.f32`` as the optimized IR spells it, with the fused
    multiply-adds that the x86 code fuses (``fma32``) and every other op one
    fp32 op.  XLA's vector code runs both branches on every element and
    selects; here each branch runs on the elements it is selected for,
    which gives the same values.  A subnormal ``x`` is read as zero, as XLA
    reads it; no other step meets a subnormal that could move the
    result."""
    x = _flush(x)
    small = x.abs() < _LOG1P_SMALL
    out = torch.empty_like(x)
    out[small] = _log1p_small(x[small])
    large = ~small
    out[large] = _log1p_large(x[large])
    return out


def _log1p_small(x: torch.Tensor) -> torch.Tensor:
    """XLA's small branch, ``|x| < √2 - 1``: ``x - x²/2 + x³·P(x)/Q(x)``.
    XLA starts its chains from x·0 + 1 and x·0 + P0, and x·0 is 0 here: Q's
    first step x·1 + Q1 rounds once as a plain add.  x2·0.5 is exact unless
    x2 is subnormal, and there the result is x either way."""
    x2 = x * x
    x64 = x.double()
    q, p = x + _LOG1P_Q[0], fma32(x64, _LOG1P_P[0], _LOG1P_P[1])
    for k in _LOG1P_Q[1:]:
        q = fma32(x64, q, k)
    for k in _LOG1P_P[2:]:
        p = fma32(x64, p, k)
    return x + (((x * x2) * (p / q)) - x2 * 0.5)


def _log1p_large(x: torch.Tensor) -> torch.Tensor:
    """XLA's large branch: ``log(y)`` of ``y = x + 1`` by Cephes's ``logf``,
    and its selects for y ≤ 0, 0, inf and NaN."""
    y = x + 1.0
    # y clamped to the smallest normal, split into a mantissa in [0.5, 1)
    # and an exponent through an int32 view.
    i = torch.where(y > _LOGF_MIN, y, _LOGF_MIN).view(torch.int32)
    m = ((i & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    e = ((i >> 23) - 127).float() + 1.0
    low = m < _LOGF_SQRTHALF
    t = (m - 1.0) + torch.where(low, m, 0.0)
    e = torch.where(low, e - 1.0, e)
    t2 = t * t
    t64, t3 = t.double(), (t2 * t).double()
    a, b, c = (fma32(t64, fma32(t64, k[0], k[1]), k[2])
               for k in (_LOGF_A, _LOGF_B, _LOGF_C))
    c = fma32(fma32(a, t3, b), t3, c)
    # t2·0.5 and e·ln2_hi (at most 18 bits) are exact: these fused
    # multiply-adds round once as plain fp32 adds.
    r = (t - t2 * 0.5) + fma32(c, t3, e * _LN2_LO)
    r = r + e * _LN2_HI
    # y ≤ 0 or NaN gives NaN (all bits set), y = 0 gives -inf, y = inf inf.
    nan = torch.full((), -1, dtype=torch.int32, device=x.device).view(
        torch.float32)
    return torch.where((y > 0) & (y != math.inf), r,
                       torch.where(y == 0, -math.inf,
                                   torch.where(y == math.inf, math.inf, nan)))


#: XLA's CPU ``erf`` (``xla.erf.f32``) as fp32 bit patterns: the clamp,
#: then ``x·P(x²)/Q(x²)``, highest power first.
_ERF_CLAMP = _bits32(0x406F9C68)[0]
_ERF_P = _bits32(0x39702D51, 0x3B5F5DA2, 0x3D50B6EB, 0x3E3DA740, 0x3F906EBA)
_ERF_Q = _bits32(0xB3FD3906, 0x37C588DF, 0x3A856D28, 0x3C6687D4, 0x3DE34C21,
                 0x3EFEB44A, 0x3F800000)


def erf(x: torch.Tensor) -> torch.Tensor:
    """The error function of fp32 ``x`` as XLA's CPU backend computes it:
    ``x`` clamped to ±3.74, then ``x·P(x²) / Q(x²)`` with every Horner step
    a fused multiply-add (``fma32``), as its IR spells them; a subnormal
    ``x`` read as zero."""
    x = _flush(x).clamp(-_ERF_CLAMP, _ERF_CLAMP)
    x2 = x * x
    x64 = x2.double()
    p = fma32(x64, _ERF_P[0], _ERF_P[1])
    for k in _ERF_P[2:]:
        p = fma32(p, x64, k)
    q = fma32(x64, _ERF_Q[0], _ERF_Q[1])
    for k in _ERF_Q[2:]:
        q = fma32(q, x64, k)
    return (x * p) / q


def _erf32(x: float) -> float:
    return float(erf(torch.tensor([x], dtype=torch.float32))[0])


#: Giles's single-precision erfinv coefficients, highest power first, for
#: w = -log1p(-x²) below 5 and from 5 up.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _one_thread(fn, x: torch.Tensor) -> torch.Tensor:
    """Element-wise ``fn(x)``; on the CPU over runs of ``_VML_GRAIN``
    elements, so that it stays on one thread (on the pool, a slab's
    ``sqrt`` took 57 ms against 0.3 ms in runs)."""
    if x.device.type != "cpu" or x.numel() <= _VML_GRAIN:
        return fn(x)
    return torch.cat([fn(c) for c in x.reshape(-1).split(_VML_GRAIN)]
                     ).reshape(x.shape)


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The fp32 square root of ``x``, correctly rounded: torch's ``sqrt`` is
    not on every CPU (MKL's, within an ulp), so its result ``r`` is moved to
    a neighbour where ``x`` lies past the midpoint between them.  The
    midpoints have 25 bits, so their squares are exact in fp64, and no fp32
    ``x`` is the square of one (no ties)."""
    r = _one_thread(torch.sqrt, x)
    up, down = torch.nextafter(r, r.new_tensor(math.inf)), \
        torch.nextafter(r, r.new_tensor(0.0))
    r64, x64 = r.double(), x.double()
    hi, lo = (r64 + up) * 0.5, (r64 + down) * 0.5
    return torch.where(x64 >= hi * hi, up,
                       torch.where(x64 < lo * lo, down, r))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """The inverse error function of fp32 ``x`` as XLA computes it: Giles's
    polynomial in ``w = -log1p(-x²)`` (``w - 2.5`` below 5, ``√w - 3``
    above), with XLA's ``log1p``, each Horner step ``p·w + c`` a fused
    multiply-add (``fma32``), and ``±inf`` at ``±1``; subnormals in and out
    flushed to zero, as in XLA's CPU code."""
    x = _flush(x)
    w = log1p(-x * x).neg_()
    small = w < 5.0
    big = ~small
    w, w_big = w - 2.5, w[big]
    w[big] = sqrt32(w_big) - 3.0
    p, w = torch.where(small, _f32(_ERFINV_LT5[0]),
                       _f32(_ERFINV_GE5[0])), w.double()
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma32(p, w, torch.where(small, _f32(c_lt), _f32(c_ge)))
    return torch.where(x.abs() == 1.0, x * float("inf"), _flush(p * x))


def truncated_normal_from_bits(bits: torch.Tensor, lower: float,
                               upper: float) -> torch.Tensor:
    """JAX's fp32 truncated normal on ``(lower, upper)`` of 32 random bits:
    ``sqrt(2)·erfinv`` of a uniform on ``[erf(lower/√2), erf(upper/√2))``,
    clamped to the floats just inside the bounds.  XLA's simplifier turns
    the division by the constant √2 into a product with its fp32
    reciprocal, and so does this."""
    sqrt2 = np.float32(np.sqrt(2))
    lo, hi = np.float32(lower), np.float32(upper)
    inv = np.float32(1) / sqrt2
    a, b = _erf32(_f32(lo * inv)), _erf32(_f32(hi * inv))
    u = uniform_from_bits(bits, a, b)
    out = erfinv(u).mul_(float(sqrt2))
    return out.clamp_(float(np.nextafter(lo, np.float32(np.inf))),
                      float(np.nextafter(hi, np.float32(-np.inf))))


def uniform(key, shape: Sequence[int] = (), dtype=torch.float32,
            minval: float = 0.0, maxval: float = 1.0, *,
            block: Optional[Block] = None,
            device: torch.device | str | None = None) -> torch.Tensor:
    """``jax.random.uniform`` in fp32 (the only dtype the port draws)."""
    _need_f32(dtype)
    return draw(key, shape, torch.float32,
                lambda b: uniform_from_bits(b, minval, maxval),
                block=block, device=device)


def truncated_normal(key, lower: float, upper: float,
                     shape: Sequence[int] = (), dtype=torch.float32, *,
                     block: Optional[Block] = None,
                     device: torch.device | str | None = None
                     ) -> torch.Tensor:
    """``jax.random.truncated_normal`` in fp32."""
    _need_f32(dtype)
    return draw(key, shape, torch.float32,
                lambda b: truncated_normal_from_bits(b, lower, upper),
                block=block, device=device)


def _need_f32(dtype) -> None:
    if dtype != torch.float32:
        raise TypeError(f"the port draws fp32 only, got {dtype}")
