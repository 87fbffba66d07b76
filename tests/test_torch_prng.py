"""The port's threefry PRNG (``repro_torch.prng``) against ``jax.random``
(``threefry2x32``, partitionable mode: JAX 0.9's defaults).

* ``PRNGKey``, ``split``, ``random_bits`` and ``uniform`` equal JAX's bit
  for bit, on the keys of seeds 0, 1 and 2**31 - 1 and on empty, odd,
  3-d and batched (``jax.vmap`` over keys) shapes, and the hash on the
  Random123 known answers and on counters past 2**32.
* ``truncated_normal`` on the models' bounds ±2 is within ``TN_ULP`` ulp
  of JAX's at every element (the largest distance seen was 3) and differs
  at all in under ``TN_SHARE`` of them (0.9 % seen): the port's ``log1p``
  is torch's, not XLA's.  On other bounds the ``erf`` of a bound may be
  an ulp from XLA's, which moves every value a little
  (``OTHER_BOUNDS_ATOL``).
* A box drawn alone, with slabs of any size, equals the same slice of the
  whole draw.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from repro_torch import prng

SEEDS = (0, 1, 2 ** 31 - 1)
SHAPES = ((), (0,), (7,), (1, 0, 3), (3, 5, 7), (4, 1), (33, 17))
#: Largest ulp distance of a truncated-normal element from JAX's.
TN_ULP = 4
#: Largest share of truncated-normal elements that differ from JAX's.
TN_SHARE = 0.02
#: Absolute tolerance of a truncated normal on bounds other than ±2.
OTHER_BOUNDS_ATOL = 5e-7


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


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
    # Other bounds: erf of the bounds is torch's, and XLA's is one ulp off
    # at -1.5/sqrt(2), which moves every value a little.
    got = prng.truncated_normal(key, -1.5, 0.5, (999,)).numpy()
    want = np.asarray(jax.random.truncated_normal(jkey, -1.5, 0.5, (999,)))
    np.testing.assert_allclose(got, want, rtol=0, atol=OTHER_BOUNDS_ATOL)
    x = np.linspace(-0.999, 0.999, 20001, dtype=np.float32)
    assert _ulps(prng.erfinv(torch.from_numpy(x)).numpy(),
                 np.asarray(jax.scipy.special.erfinv(x))).max() <= TN_ULP
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
