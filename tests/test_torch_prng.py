"""The port's threefry PRNG (``repro_torch.prng``) against ``jax.random``
(``threefry2x32``, partitionable mode: JAX 0.9's defaults).

* ``PRNGKey``, ``split``, ``random_bits`` and ``uniform`` equal JAX's bit
  for bit, on the keys of seeds 0, 1 and 2**31 - 1 and on empty, odd,
  3-d and batched (``jax.vmap`` over keys) shapes, and the hash on the
  Random123 known answers and on counters past 2**32.
* ``truncated_normal`` on the models' bounds ±2 and on other bounds
  equals JAX's bit for bit (``TN_ULP`` and ``TN_SHARE`` are 0), and so
  does ``erfinv`` against ``lax.erf_inv``: the port's ``log1p`` and
  ``erf`` are XLA's CPU ones, copied op by op, and every fused
  multiply-add is ``fma32``, rounded once.
* ``log1p`` equals ``jax.jit(lax.log1p)`` on a strided sweep of fp32 bit
  patterns over [-1, 2**40] and on its edges, ``erf`` equals
  ``jax.jit(lax.erf)`` on a sweep of all signs and magnitudes; ``fma32``
  equals the exactly rounded ``a·b + c`` (``fractions``) where the fp64
  sum lands on an fp32 midpoint, and ``uniform`` on bounds whose
  scale-and-shift does.

The reference runs on a host whose XLA CPU code fuses multiply-adds (x86
with FMA) and flushes subnormals to zero, as XLA's CPU runtime does: the
port copies that code, so these tests assume such a host.
* A box drawn alone, with slabs of any size, equals the same slice of the
  whole draw.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax._src import prng as jprng

from repro_torch import prng

SEEDS = (0, 1, 2 ** 31 - 1)
SHAPES = ((), (0,), (7,), (1, 0, 3), (3, 5, 7), (4, 1), (33, 17))
#: Largest ulp distance of a truncated-normal element from JAX's.
TN_ULP = 0
#: Largest share of truncated-normal elements that differ from JAX's.
TN_SHARE = 0
#: Truncated-normal bounds other than the models' ±2.
OTHER_BOUNDS = ((-1.5, 0.5), (-0.3, 1.0), (-3.0, -1.0), (0.1, 0.2),
                (-4.0, 4.0))


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def _bit_equal(got: np.ndarray, want: np.ndarray) -> None:
    """fp32 arrays equal bit for bit (NaNs and signed zeros included)."""
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    bad = got.view(np.uint32) != want.view(np.uint32)
    assert not bad.any(), (int(bad.sum()), got[bad][:5], want[bad][:5])


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Ulp distance of fp32 arrays (bit patterns mapped to a monotone
    integer line, so ±0 are one point)."""
    def line(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(
            np.int64)
        return np.where(i >= 0, i, -(i & 0x7FFFFFFF))
    return np.abs(line(a) - line(b))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_splits_match_jax(seed):
    key, want = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    assert key.dtype == torch.int64
    np.testing.assert_array_equal(key.numpy(), _u32(want))
    for num in (1, 2, 5):
        np.testing.assert_array_equal(prng.split(key, num).numpy(),
                                      _u32(jax.random.split(want, num)))
    nested = prng.split(prng.split(key, 3)[2], 4)
    np.testing.assert_array_equal(
        nested.numpy(), _u32(jax.random.split(jax.random.split(want, 3)[2],
                                              4)))
    # A batch of keys splits each, as jax.vmap(split) does.
    batch = prng.split(key, 3)
    np.testing.assert_array_equal(
        prng.split(batch, 2).numpy(),
        _u32(jax.vmap(lambda k: jax.random.split(k, 2))(
            jax.random.split(want, 3))))


def test_seeds_wrap_as_jax_does():
    for seed in (-1, 2 ** 32 - 1, 12345):
        np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(),
                                      _u32(jax.random.PRNGKey(seed)))
    with pytest.raises(ValueError):
        prng.PRNGKey(2 ** 32)


def test_threefry_known_answers_and_high_counters():
    """The Random123 known answers of threefry2x32-20, and JAX's hash on
    random counter pairs, the high word included (an element past 2**32
    of a draw)."""
    cases = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
             ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
              (0x1CB996FC, 0xBB002BE7)),
             ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
              (0xC4923A9C, 0x483DF7A0))]
    for (k1, k2), (x1, x2), want in cases:
        got = prng.threefry2x32(k1, k2, torch.tensor([x1]),
                                torch.tensor([x2]))
        assert (int(got[0][0]), int(got[1][0])) == want
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2 ** 32, (2, 257), dtype=np.uint64).astype(
        np.uint32)
    key = np.array([0x9E3779B9, 0x7F4A7C15], np.uint32)
    want = jprng.threefry2x32_p.bind(jnp.uint32(key[0]), jnp.uint32(key[1]),
                                     jnp.asarray(x[0]), jnp.asarray(x[1]))
    got = prng.threefry2x32(int(key[0]), int(key[1]),
                            torch.from_numpy(x[0].astype(np.int64)),
                            torch.from_numpy(x[1].astype(np.int64)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _u32(w))
    # A box of a 2**33-element draw: its counters' high words are 1.
    shape = (2 ** 20, 2 ** 13)
    box = prng.random_bits(prng.PRNGKey(3), shape,
                           block=((2 ** 19 + 3, 100), (2, 5)))
    idx = (np.arange(2 ** 19 + 3, 2 ** 19 + 5)[:, None] * 2 ** 13
           + np.arange(100, 105)[None]).astype(np.uint64)
    hi, lo = (idx >> np.uint64(32)).astype(np.uint32), \
        (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    w1, w2 = jprng.threefry2x32_p.bind(jnp.uint32(0), jnp.uint32(3),
                                       jnp.asarray(hi), jnp.asarray(lo))
    np.testing.assert_array_equal(box.numpy(), _u32(w1 ^ w2))


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_match_jax_bit_for_bit(seed):
    key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    for shape in SHAPES:
        bits = prng.random_bits(key, shape)
        assert tuple(bits.shape) == shape
        np.testing.assert_array_equal(
            bits.numpy(), _u32(jax.random.bits(jkey, shape, jnp.uint32)))
        for lo, hi in ((0.0, 1.0), (-3.0, 2.5), (-0.9544997, 0.9544997)):
            got = prng.uniform(key, shape, minval=lo, maxval=hi)
            want = np.asarray(jax.random.uniform(jkey, shape, minval=lo,
                                                 maxval=hi))
            np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                          want.view(np.uint32))


def test_batched_keys_are_vmap_over_keys():
    keys = prng.split(prng.PRNGKey(7), 3)
    jkeys = jax.random.split(jax.random.PRNGKey(7), 3)
    np.testing.assert_array_equal(
        prng.random_bits(keys, (4, 5)).numpy(),
        _u32(jax.vmap(lambda k: jax.random.bits(k, (4, 5), jnp.uint32))(
            jkeys)))
    got = prng.truncated_normal(keys, -2.0, 2.0, (6, 3))
    want = np.asarray(jax.vmap(lambda k: jax.random.truncated_normal(
        k, -2.0, 2.0, (6, 3)))(jkeys))
    assert _ulps(got.numpy(), want).max() <= TN_ULP


@pytest.mark.parametrize("seed", SEEDS)
def test_truncated_normal_within_tolerance(seed):
    key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    dist = []
    for shape in SHAPES + ((301, 677),):
        got = prng.truncated_normal(key, -2.0, 2.0, shape).numpy()
        want = np.asarray(jax.random.truncated_normal(jkey, -2.0, 2.0,
                                                      shape))
        assert got.shape == want.shape and got.dtype == np.float32
        assert np.abs(got).max(initial=0.0) < 2.0
        dist.append(_ulps(got, want).ravel())
    dist = np.concatenate(dist)
    assert dist.max() <= TN_ULP, int(dist.max())
    assert (dist > 0).mean() <= TN_SHARE, float((dist > 0).mean())
    # Other bounds (at -1.5/sqrt(2) torch's erf is an ulp from XLA's, and
    # XLA multiplies by the reciprocal of sqrt(2) where -0.3/sqrt(2) is
    # not the quotient).
    for lo, hi in OTHER_BOUNDS:
        got = prng.truncated_normal(key, lo, hi, (999,)).numpy()
        want = np.asarray(jax.random.truncated_normal(jkey, lo, hi, (999,)))
        _bit_equal(got, want)
    x = np.linspace(-0.999, 0.999, 20001, dtype=np.float32)
    assert _ulps(prng.erfinv(torch.from_numpy(x)).numpy(),
                 np.asarray(jax.scipy.special.erfinv(x))).max() <= TN_ULP
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (1 << 20,),
                                      minval=-1.0, maxval=1.0))
    x = x[np.abs(x) < 1]
    _bit_equal(prng.erfinv(torch.from_numpy(x)).numpy(),
               np.asarray(jax.jit(lax.erf_inv)(x)))
    assert torch.equal(prng.erfinv(torch.tensor([-1.0, 1.0])),
                       torch.tensor([-float("inf"), float("inf")]))


@pytest.mark.parametrize("slab", (1, 7, 64, 1 << 26))
def test_a_box_drawn_alone_is_the_slice_of_the_whole(slab, monkeypatch):
    """Boxes of a batched and of a plain draw, through slabs of ``slab``
    elements, equal the slices of the whole draw (made with the default
    slab)."""
    keys = prng.split(prng.PRNGKey(5), 3)
    whole = prng.random_bits(keys, (10, 11, 6))
    whole_tn = prng.truncated_normal(prng.PRNGKey(5), -2.0, 2.0, (13, 21))
    monkeypatch.setattr(prng, "SLAB", slab)
    rng = np.random.default_rng(slab)
    for _ in range(12):
        off = [int(rng.integers(0, s)) for s in whole.shape]
        box = [int(rng.integers(0, s - o + 1))
               for o, s in zip(off, whole.shape)]
        got = prng.random_bits(keys, (10, 11, 6), block=(off, box))
        want = whole[tuple(slice(o, o + n) for o, n in zip(off, box))]
        assert torch.equal(got, want), (off, box)
        off2 = [int(rng.integers(0, s)) for s in whole_tn.shape]
        box2 = [int(rng.integers(1, s - o + 1))
                for o, s in zip(off2, whole_tn.shape)]
        got = prng.truncated_normal(prng.PRNGKey(5), -2.0, 2.0, (13, 21),
                                    block=(off2, box2))
        want = whole_tn[tuple(slice(o, o + n) for o, n in zip(off2, box2))]
        assert torch.equal(got, want), (off2, box2)
    assert prng.random_bits(keys, (10, 11, 6), device="meta",
                            block=((0, 0, 0, 0), (1, 2, 3, 4))).is_meta
    with pytest.raises(ValueError):
        prng.random_bits(keys, (10, 11, 6), block=((0, 0, 0, 0),
                                                   (4, 1, 1, 1)))


def test_slabs_tile_the_box_in_order():
    for shape, cap in (((5, 7, 3), 10), ((5, 7, 3), 2), ((4, 9), 36),
                       ((1000,), 64), ((2, 0, 3), 4)):
        seen = np.zeros(shape, np.int64)
        for off, box in prng._slabs(shape, cap):
            assert int(np.prod(box)) <= cap
            seen[tuple(slice(o, o + n) for o, n in zip(off, box))] += 1
        assert (seen == 1).all()


def _f32_bits(bits) -> np.ndarray:
    return np.asarray(bits, np.uint32).view(np.float32)


#: Ranges of fp32 bit patterns swept by the ``log1p`` test, with ``-0`` to
#: ``-1`` and ``0`` to ``2**40`` cut at the small branch's threshold (about
#: √2 - 1) and at 1: about 2**22 patterns in all, every ``LOG1P_STRIDE``-th.
LOG1P_RANGES = {"-1..-0.41": (0xBED413CE, 0xBF800001),
                "-0.41..-0": (0x80000000, 0xBED413CE),
                "0..0.41": (0x00000000, 0x3ED413CE),
                "0.41..1": (0x3ED413CE, 0x3F800000),
                "1..2**40": (0x3F800000, 0x53800001)}
LOG1P_STRIDE = 587


@pytest.mark.parametrize("span", sorted(LOG1P_RANGES))
def test_log1p_is_xlas_on_a_sweep_of_bit_patterns(span):
    """``prng.log1p`` equals ``jax.jit(lax.log1p)`` bit for bit on every
    ``LOG1P_STRIDE``-th fp32 bit pattern of the span (subnormals, which
    XLA's CPU code reads as zero, included)."""
    lo, hi = LOG1P_RANGES[span]
    x = _f32_bits(np.arange(lo, hi, LOG1P_STRIDE, dtype=np.int64))
    _bit_equal(prng.log1p(torch.from_numpy(x)).numpy(),
               np.asarray(jax.jit(lax.log1p)(x)))


def test_erf_is_xlas_on_a_sweep_of_bit_patterns():
    """``prng.erf`` equals ``jax.jit(lax.erf)`` bit for bit on every 389th
    fp32 bit pattern of both signs (subnormals, the clamp at ±3.74 and
    ±inf included) and at the bounds' ``b/√2``."""
    bits = np.arange(0, 0x7F800001, 389, dtype=np.int64)
    sqrt2 = np.float32(np.sqrt(2))
    x = np.concatenate([_f32_bits(bits), _f32_bits(bits | 0x80000000),
                        np.array([np.inf, -np.inf, -0.0, np.nan],
                                 np.float32),
                        np.array([-2, 2, -1.5, 0.5], np.float32) / sqrt2])
    _bit_equal(prng.erf(torch.from_numpy(x)).numpy(),
               np.asarray(jax.jit(lax.erf)(x)))


def test_log1p_edges_are_xlas():
    """-1, below -1, ±0, the smallest normal and subnormals, the small
    branch's threshold and its neighbours, the branch seams of the mantissa
    (√½), the largest floats, ±inf and NaN."""
    f32 = np.float32
    thr = _f32_bits(0x3ED413CD)
    x = np.array([-1, np.nextafter(f32(-1), f32(-2)),
                  np.nextafter(f32(-1), f32(0)), -2, -np.inf, 0.0, -0.0,
                  2 ** -126, -2 ** -126, np.nextafter(f32(2 ** -126), f32(0)),
                  2 ** -149, -2 ** -149, 1e-40, -1e-40, 1e-30, -1e-30,
                  thr, -thr, np.nextafter(thr, f32(1)),
                  np.nextafter(thr, f32(0)), np.nextafter(-thr, f32(-1)),
                  np.nextafter(-thr, f32(0)), _f32_bits(0x3F3504F3) - 1,
                  _f32_bits(0x3F3504F3) * 2 - 1, 3e38, np.finfo(f32).max,
                  np.inf, np.nan, -np.nan, _f32_bits(0x7FC00001),
                  _f32_bits(0xFFFFFFFF)], f32)
    _bit_equal(prng.log1p(torch.from_numpy(x)).numpy(),
               np.asarray(jax.jit(lax.log1p)(x)))


def _rn32(q: Fraction) -> np.float32:
    """The fp32 nearest the rational ``q`` (ties to even)."""
    f = np.float32(float(q))
    near = (f, np.nextafter(f, np.float32(np.inf)),
            np.nextafter(f, np.float32(-np.inf)))
    return min(near, key=lambda v: (abs(Fraction(float(v)) - q),
                                    int(np.array(v).view(np.uint32)) & 1))


def _midpoint_cases(n: int) -> np.ndarray:
    """(a, b, c) whose fp64 sum ``a·b + c`` rounds to an fp32 midpoint of
    ``c``'s binade and is not one: ``c`` with an odd mantissa, and ``a·b``
    within 2**-40 of a half ulp of ``c`` (``(1 + x)(1 - x)`` with a small
    ``x``), above or below, added or taken away."""
    rng = np.random.default_rng(31)
    out = []
    for _ in range(n):
        c = np.float32(rng.uniform(1, 2) * 2.0 ** int(rng.integers(-20, 20)))
        c = _f32_bits(np.array(c).view(np.uint32) | 1)
        half = np.spacing(c) / 2
        j = int(rng.integers(1, 200))
        a = np.float32((1 + j * 2.0 ** -23) * half)
        b = np.float32(1 - j * 2.0 ** -23)
        sign = [1, -1][int(rng.integers(0, 2))]
        out.append((a * sign, b, c * [1, -1][int(rng.integers(0, 2))]))
    return np.array(out, np.float32)


def test_fma32_rounds_once():
    """``fma32`` equals ``a·b + c`` rounded once to fp32 (``fractions``) on
    built cases whose fp64 sum lands on an fp32 midpoint (where rounding
    twice goes the wrong way on about half of them) and on random ones."""
    cases = _midpoint_cases(400)
    rng = np.random.default_rng(7)
    cases = np.concatenate([cases, rng.standard_normal((400, 3)).astype(
        np.float32) * np.float32(2.0) ** rng.integers(-30, 30, (400, 3))])
    a, b, c = (torch.from_numpy(np.ascontiguousarray(cases[:, i]))
               for i in range(3))
    got = prng.fma32(a, b, c).numpy()
    want = np.array([_rn32(Fraction(float(x)) * Fraction(float(y))
                           + Fraction(float(z))) for x, y, z in cases],
                    np.float32)
    _bit_equal(got, want)
    twice = (a.double() * b.double() + c.double()).float().numpy()
    assert (twice[:400] != want[:400]).sum() > 100
    # Scalars as the operands that are no tensors.
    np.testing.assert_array_equal(
        prng.fma32(a, float(b[0]), float(c[0])).numpy(),
        prng.fma32(a, b[0].expand(a.shape), c[0].expand(a.shape)).numpy())


def test_uniform_on_bounds_that_hit_a_midpoint_is_jaxs():
    """On ``[-1e-30, 1 + 2**-23)`` the scale-and-shift of the bits
    ``k·2**-23`` with ``k = 3·2**j`` is an fp32 midpoint plus a tiny negative
    shift, which rounding twice takes to the wrong side: the 2**20 draw of
    ``PRNGKey(2)`` holds nine such elements, and equals JAX's."""
    lo, hi = np.float32(-1e-30), np.float32(1 + 2 ** -23)
    shape = (1 << 20,)
    got = prng.uniform(prng.PRNGKey(2), shape, minval=lo, maxval=hi)
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(2), shape,
                                         minval=lo, maxval=hi))
    _bit_equal(got.numpy(), want)
    k = prng.random_bits(prng.PRNGKey(2), shape).numpy() >> 9
    hits = np.isin(k, [3 << j for j in range(22)])
    assert hits.sum() == 9
    f = torch.from_numpy(((k | 0x3F800000).astype(np.uint32)).view(
        np.float32)) - 1.0
    twice = (f.double() * float(hi - lo) + float(lo)).float().numpy()
    assert (twice.view(np.uint32) != want.view(np.uint32))[hits].all()


def test_sqrt32_is_correctly_rounded():
    """``sqrt32`` equals numpy's fp32 square root (IEEE, correctly rounded)
    on a sweep of bit patterns and on the ``w`` of the erfinv sweep above 5,
    where torch's CPU ``sqrt`` may be an ulp off."""
    x = _f32_bits(np.arange(0, 0x7F800001, 1021, dtype=np.int64))
    _bit_equal(prng.sqrt32(torch.from_numpy(x)).numpy(), np.sqrt(x))
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (1 << 20,),
                                      minval=-1.0, maxval=1.0))
    w = prng.log1p(torch.from_numpy(-u * u)).neg_().numpy()
    w = w[(w >= 5) & np.isfinite(w)]
    _bit_equal(prng.sqrt32(torch.from_numpy(w)).numpy(), np.sqrt(w))
    edges = np.array([0.0, -0.0, np.inf, 2 ** -149, 4.0, np.nan], np.float32)
    _bit_equal(prng.sqrt32(torch.from_numpy(edges)).numpy(),
               np.sqrt(edges))
