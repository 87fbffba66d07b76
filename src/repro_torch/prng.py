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
  those bits.  ``uniform`` is exact.  ``truncated_normal``'s inverse error
  function is Giles's single-precision polynomial, which XLA evaluates,
  with each Horner step a fused multiply-add (emulated here in fp64); its
  ``log1p`` is torch's, not XLA's, so a value may differ from JAX's by an
  ulp or two (``tests/test_torch_prng.py`` states the tolerance).

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
SLAB = 1 << 26
#: The same on the CPU: torch's grain size, up to which an element-wise op
#: runs on one thread.  A draw is ~200 element-wise passes, each too short
#: to gain from waking the thread pool.
CPU_SLAB = 1 << 15
#: ATen's grain size for transcendental ops (``sqrt``, ``log1p``) on the
#: CPU, which run on the thread pool above it; ``_one_thread`` feeds them
#: runs of this length.
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


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0,
                      maxval: float = 1.0) -> torch.Tensor:
    """JAX's fp32 uniform of 32 random bits: the top 23 bits as the mantissa
    of a float in [1, 2), minus 1, scaled to [minval, maxval) and raised to
    ``minval``.  XLA fuses the scale and the shift into one multiply-add,
    rounded once; so is this one (the fp32 product is exact in fp64)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    f = (f - 1.0).double().mul_(float(hi - lo)).add_(float(lo)).float()
    return f.clamp_min_(float(lo))


def _erf32(x: float) -> float:
    return float(torch.erf(torch.tensor(x, dtype=torch.float32)))


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


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """The inverse error function of fp32 ``x`` as XLA computes it: Giles's
    polynomial in ``w = -log1p(-x²)`` (``w - 2.5`` below 5, ``√w - 3``
    above), each Horner step ``p·w + c`` rounded once to fp32 as a fused
    multiply-add rounds it (the fp32 product is exact in fp64), and
    ``±inf`` at ``±1``."""
    w = _one_thread(torch.log1p, -x * x).neg_()
    small = w < 5.0
    w = torch.where(small, w - 2.5, _one_thread(torch.sqrt, w) - 3.0).double()
    p = torch.where(small, _f32(_ERFINV_LT5[0]), _f32(_ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(small, _f32(c_lt), _f32(c_ge))
        p = (p.double() * w + c).float()
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def truncated_normal_from_bits(bits: torch.Tensor, lower: float,
                               upper: float) -> torch.Tensor:
    """JAX's fp32 truncated normal on ``(lower, upper)`` of 32 random bits:
    ``sqrt(2)·erfinv`` of a uniform on ``[erf(lower/√2), erf(upper/√2))``,
    clamped to the floats just inside the bounds."""
    sqrt2 = np.float32(np.sqrt(2))
    lo, hi = np.float32(lower), np.float32(upper)
    a, b = _erf32(_f32(lo / sqrt2)), _erf32(_f32(hi / sqrt2))
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
