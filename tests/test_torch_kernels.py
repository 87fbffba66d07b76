"""Port parity: the kernels' wrappers and plain versions
(``repro_torch.kernels``) vs the Pallas kernels in interpret mode.

Mirrors ``tests/test_kernels.py`` case by case for ``fused_star_gather``
and ``tree_predict``.  Here, on the CPU, each wrapper is given CPU tensors
and so runs its plain version; the CUDA kernels themselves are compared
with the same plain versions on the card by ``chip_smoke.py``.

Tolerance: exact everywhere.  Given the same partials the gather-sum adds
in the same fixed arm order; tree outputs are one-hot compares of exact
integer scores.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.fusion import random_tree
from repro.kernels import fused_star_gather as ref_fused_star_gather
from repro.kernels import tree_predict as ref_tree_predict
from repro_torch.kernels import (fused_star_gather, fused_star_gather_ref,
                                 tree_predict, tree_predict_ref)
from torch_parity import to_np


def _gather_both(ptrs, found, tables, h=None):
    """(port wrapper, Pallas kernel in interpret mode) on the same arrays."""
    got = fused_star_gather(
        torch.from_numpy(ptrs), torch.from_numpy(found.astype(bool)),
        [torch.from_numpy(t) for t in tables],
        None if h is None else torch.from_numpy(h))
    want = ref_fused_star_gather(
        jnp.asarray(ptrs), jnp.asarray(found.astype(np.int32)),
        [jnp.asarray(t) for t in tables],
        None if h is None else jnp.asarray(h), interpret=True)
    return to_np(got), to_np(want)


# --------------------------------------------------------- fused_star_gather
@pytest.mark.parametrize("n,l,rows", [
    (16, 8, (32, 16, 8)), (7, 130, (5, 9)), (64, 1, (100,)),
    (33, 257, (12, 7, 5, 3)),
])
def test_fused_star_gather_linear(n, l, rows):
    rng = np.random.default_rng(n + l)
    tables = [rng.normal(size=(r, l)).astype(np.float32) for r in rows]
    ptrs = np.stack([rng.integers(0, r, size=n) for r in rows]).astype(
        np.int32)
    found = rng.integers(0, 2, size=(len(rows), n))
    got, want = _gather_both(ptrs, found, tables)
    np.testing.assert_array_equal(got, want)


def test_fused_star_gather_tree_compare():
    rng = np.random.default_rng(0)
    n, l, rows = 24, 16, (10, 8)
    tables = [rng.integers(0, 3, size=(r, l)).astype(np.float32)
              for r in rows]
    h = rng.integers(0, 5, size=l).astype(np.float32)
    ptrs = np.stack([rng.integers(0, r, size=n) for r in rows]).astype(
        np.int32)
    got, want = _gather_both(ptrs, np.ones((2, n)), tables, h)
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) <= {0.0, 1.0}


@pytest.mark.parametrize("l", [1, 5, 127, 130])
def test_fused_star_gather_nan_padded_columns_never_leak(l):
    """The port pads nothing; the result matches the reference's sliced
    result at every width, with no NaN and no spurious leaf hit."""
    rng = np.random.default_rng(l)
    n, rows = 33, (9, 6)
    tables = [rng.integers(0, 2, size=(r, l)).astype(np.float32)
              for r in rows]
    h = rng.integers(0, 3, size=l).astype(np.float32)
    ptrs = np.stack([rng.integers(0, r, size=n) for r in rows]).astype(
        np.int32)
    found = rng.integers(0, 2, size=(2, n))
    got, want = _gather_both(ptrs, found, tables, h)
    assert got.shape == (n, l)
    assert np.isfinite(got).all()
    assert set(np.unique(got)) <= {0.0, 1.0}
    np.testing.assert_array_equal(got, want)


def test_fused_star_gather_empty_batch():
    """n == 0 returns a (0, l) float32 result, compare path or not."""
    rng = np.random.default_rng(0)
    l, rows = 5, (7, 3)
    tables = [torch.from_numpy(rng.normal(size=(r, l)).astype(np.float32))
              for r in rows]
    ptrs = torch.zeros((2, 0), dtype=torch.int32)
    found = torch.zeros((2, 0), dtype=torch.bool)
    out = fused_star_gather(ptrs, found, tables)
    assert tuple(out.shape) == (0, l)
    out = fused_star_gather(ptrs, found, tables, torch.zeros(l))
    assert tuple(out.shape) == (0, l) and out.dtype == torch.float32


def test_fused_star_gather_clips_pointers_and_keeps_nan():
    """Out-of-range pointers clip into range (as the reference wrapper
    does); a NaN partial row stays NaN even where its arm misses, because
    liveness multiplies."""
    rng = np.random.default_rng(3)
    l, rows, n = 4, (6, 5), 20
    tables = [rng.normal(size=(r, l)).astype(np.float32) for r in rows]
    tables[1][2] = np.nan
    ptrs = np.stack([rng.integers(-3, r + 3, size=n) for r in rows]).astype(
        np.int32)
    ptrs[1, :4] = 2
    found = rng.integers(0, 2, size=(2, n))
    found[1, :2] = 0
    got, want = _gather_both(ptrs, found, tables)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[:4]).all()


def test_cpu_dispatch_counts_no_launch():
    """A CPU tensor takes the plain version: the launch counters stay put."""
    before = (fused_star_gather.launches, tree_predict.launches)
    rng = np.random.default_rng(1)
    t = torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))
    ptrs = torch.zeros((1, 5), dtype=torch.int32)
    found = torch.ones((1, 5), dtype=torch.bool)
    torch.testing.assert_close(fused_star_gather(ptrs, found, [t]),
                               fused_star_gather_ref(ptrs, found, [t]),
                               rtol=0, atol=0)
    tree = random_tree(rng, 3, 2)
    x = torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32))
    args = [torch.from_numpy(np.array(a)) for a in (tree.F, tree.v, tree.H,
                                                    tree.h)]
    torch.testing.assert_close(tree_predict(x, *args),
                               tree_predict_ref(x, *args), rtol=0, atol=0)
    assert (fused_star_gather.launches, tree_predict.launches) == before


# --------------------------------------------------------------- tree_predict
def _tree_both(x, tree):
    targs = [torch.from_numpy(np.array(a)) for a in (tree.F, tree.v, tree.H,
                                                     tree.h)]
    got = tree_predict(torch.from_numpy(x), *targs)
    want = ref_tree_predict(jnp.asarray(x), tree.F, tree.v, tree.H, tree.h,
                            block_n=8, block_l=128, interpret=True)
    return to_np(got), to_np(want)


@pytest.mark.parametrize("n,k,depth", [(8, 4, 2), (130, 16, 4), (64, 256, 6),
                                       (17, 3, 1)])
def test_tree_predict_kernel_vs_ref(n, k, depth):
    rng = np.random.default_rng(n + k + depth)
    tree = random_tree(rng, k, depth)
    x = rng.normal(size=(n, k)).astype(np.float32)
    got, want = _tree_both(x, tree)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.sum(axis=1), np.ones(n))


def test_tree_predict_kernel_equals_model_apply():
    rng = np.random.default_rng(5)
    tree = random_tree(rng, 12, 3)
    x = rng.normal(size=(40, 12)).astype(np.float32)
    got, _ = _tree_both(x, tree)
    np.testing.assert_array_equal(got, to_np(tree.apply(jnp.asarray(x))))


def test_tree_predict_non_finite_features():
    """NaN/Inf anywhere in a row poisons every x·F dot (NaN·0), so all of
    its predicates are false — the reference's fp32-dot semantics."""
    rng = np.random.default_rng(6)
    tree = random_tree(rng, 5, 3)
    x = rng.normal(size=(12, 5)).astype(np.float32)
    x[1, 0] = np.nan
    x[2, 4] = np.inf
    x[3, :] = np.nan
    got, want = _tree_both(x, tree)
    np.testing.assert_array_equal(got, want)
