"""Port parity: the kernels' wrappers and plain versions
(``repro_torch.kernels``) vs the Pallas kernels in interpret mode.

Mirrors ``tests/test_kernels.py`` case by case for ``fused_star_gather``,
``tree_predict`` and ``onehot_matmul``.  Here, on the CPU, each wrapper is given CPU tensors
and so runs its plain version; the CUDA kernels themselves are compared
with the same plain versions on the card by ``chip_smoke.py``.

Tolerance: exact everywhere.  Given the same partials the gather-sum adds
in the same fixed arm order; tree outputs are one-hot compares of exact
integer scores; ``onehot(idx) @ table`` adds one exact product to zeros
(bf16 entries widen to fp32 exactly), with NaN in the same places.
"""
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.fusion import random_tree
from repro.kernels import fused_star_gather as ref_fused_star_gather
from repro.kernels import onehot_matmul as ref_onehot_matmul
from repro.kernels import onehot_matmul_ref as ref_onehot_matmul_ref
from repro.kernels import tree_predict as ref_tree_predict
from repro_torch.kernels import (fused_star_gather, fused_star_gather_ref,
                                 onehot_matmul, onehot_matmul_ref,
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
    before = (fused_star_gather.launches, tree_predict.launches,
              onehot_matmul.launches)
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
    idx = torch.tensor([0, 3, -1, 4], dtype=torch.int32)
    torch.testing.assert_close(onehot_matmul(idx, t),
                               onehot_matmul_ref(idx, t), rtol=0, atol=0)
    assert (fused_star_gather.launches, tree_predict.launches,
            onehot_matmul.launches) == before


@pytest.mark.parametrize("l", [4, 8, 128, 2048])
@pytest.mark.parametrize("compare", [False, True])
def test_fused_star_gather_widths(l, compare):
    """The widths the CUDA kernel takes its vector (l % 4 == 0) and
    lane-group (l >= 128) paths at, against the Pallas kernel: the registry's
    l = 4 and 8, setting 1's 128 and setting 2's 2048, with misses over a
    NaN partial row and out-of-range pointers."""
    rng = np.random.default_rng(l + compare)
    n, rows = 9, (6, 11, 4)
    tables = [rng.integers(-2, 3, size=(r, l)).astype(np.float32)
              for r in rows]
    tables[1][3] = np.nan
    ptrs = np.stack([rng.integers(-2, r + 2, size=n) for r in rows]).astype(
        np.int32)
    ptrs[1, :2] = 3
    found = rng.integers(0, 2, size=(len(rows), n))
    found[1, 0] = 0
    h = rng.integers(-2, 3, size=l).astype(np.float32) if compare else None
    got, want = _gather_both(ptrs, found, tables, h)
    assert got.shape == (n, l)
    np.testing.assert_array_equal(got, want)
    if not compare:
        assert np.isnan(got[:2]).all()


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


# ------------------------------------------------------------- onehot_matmul
_TORCH_DTYPES = {"float32": (torch.float32, jnp.float32),
                 "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _onehot_both(idx, tbl, dtype):
    """(port wrapper, Pallas kernel in interpret mode, jnp oracle) on the
    same arrays, the table cast to ``dtype`` in each framework."""
    tdt, jdt = _TORCH_DTYPES[dtype]
    got = onehot_matmul(torch.from_numpy(idx), torch.from_numpy(tbl).to(tdt))
    j_idx, j_tbl = jnp.asarray(idx), jnp.asarray(tbl, jdt)
    pallas = ref_onehot_matmul(j_idx, j_tbl, block_n=8, block_r=16,
                               block_d=128, interpret=True)
    return to_np(got), to_np(pallas), to_np(ref_onehot_matmul_ref(j_idx,
                                                                 j_tbl))


@pytest.mark.parametrize("n,r,d", [
    (8, 16, 8), (128, 512, 128), (130, 513, 129), (1, 7, 3), (256, 64, 384),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_onehot_matmul_shapes(n, r, d, dtype):
    rng = np.random.default_rng(n * 1000 + r + d)
    idx = rng.integers(-2, r + 2, size=n).astype(np.int32)  # incl. OOR
    tbl = rng.normal(size=(r, d)).astype(np.float32)
    got, pallas, want = _onehot_both(idx, tbl, dtype)
    assert got.shape == (n, d) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    oor = (idx < 0) | (idx >= r)
    assert (got[oor] == 0).all()


@pytest.mark.parametrize("seed", range(6))
def test_onehot_matmul_random_gathers(seed):
    """In-range indices on finite tables gather rows (the reference's
    property test, with fixed seeds)."""
    rng = np.random.default_rng(seed)
    n, r, d = (int(v) for v in rng.integers(1, (70, 90, 50)))
    idx = rng.integers(0, r, size=n).astype(np.int32)
    tbl = rng.normal(size=(r, d)).astype(np.float32)
    got, pallas, _ = _onehot_both(idx, tbl, "float32")
    np.testing.assert_array_equal(got, tbl[idx])
    np.testing.assert_array_equal(pallas, tbl[idx])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_onehot_matmul_non_finite_tables(bad, dtype):
    """0·NaN and 0·Inf are NaN: a non-finite entry poisons its column for
    every row except the one that selects it, where NaN stays NaN and ±Inf
    stays ±Inf (the own-entry-only column); out-of-range rows see NaN in
    such a column and 0 elsewhere.  NaN lands where the jnp oracle puts
    it."""
    rng = np.random.default_rng(7)
    r, d = 9, 6
    tbl = rng.normal(size=(r, d)).astype(np.float32)
    tbl[2, 1] = bad           # column 1: only row 2 is non-finite
    tbl[4, 3] = bad           # column 3: rows 4 and 6
    tbl[6, 3] = np.nan
    idx = np.array([2, 4, 6, 0, -1, r, 2, 5], np.int32)
    got, _, want = _onehot_both(idx, tbl, dtype)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got, want)
    col1 = got[:, 1]
    assert np.isnan(col1[[1, 2, 3, 4, 5, 7]]).all()
    if np.isnan(bad):
        assert np.isnan(col1[[0, 6]]).all()
    else:
        assert (col1[[0, 6]] == bad).all()
    assert np.isnan(got[:, 3]).all()
    assert (got[4:6][:, [0, 2, 4, 5]] == 0).all()
    assert np.isfinite(got[:, [0, 2, 4, 5]]).all()


def test_onehot_matmul_empty_and_chunked(monkeypatch):
    """n == 0 gives (0, d); more rows than one chunk of the plain version
    still gathers every row."""
    tbl = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    out = onehot_matmul(torch.zeros(0, dtype=torch.int32), tbl)
    assert tuple(out.shape) == (0, 3) and out.dtype == torch.float32
    idx = torch.tensor([3, 0, 5, 1, 2, -4, 3], dtype=torch.int32)
    whole = onehot_matmul_ref(idx, tbl)
    ref_module = importlib.import_module(
        "repro_torch.kernels.onehot_matmul.ref")
    monkeypatch.setattr(ref_module, "CHUNK_ELEMS", 8)  # 2 rows of r=4
    chunked = onehot_matmul_ref(idx, tbl)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)
    want = to_np(ref_onehot_matmul_ref(jnp.asarray(to_np(idx)),
                                       jnp.asarray(to_np(tbl))))
    np.testing.assert_array_equal(to_np(whole), want)


# ------------------------------------------- tree_predict's CUDA algebra
def _gather_rule(x, tree):
    """The CUDA kernel's predicate and score algebra in numpy: a one-hot
    column of F is the gather x[:, feat], false where the row has a NaN or
    ±Inf at another feature (nf(row) counts the row's); the scores are the
    products of predicates and H, exact as integers."""
    F, v, H, hsum = (np.asarray(a) for a in (tree.F, tree.v, tree.H, tree.h))
    assert ((F == 0) | (F == 1)).all() and (F.sum(axis=0) == 1).all()
    feat = F.argmax(axis=0)
    xf = x[:, feat]                                       # (n, p) gathers
    nf = (~np.isfinite(x)).sum(axis=1, keepdims=True)
    others = nf - (~np.isfinite(xf)).astype(np.int64)
    with np.errstate(invalid="ignore"):
        preds = (others == 0) & (xf > v[None, :])
    score = preds.astype(np.int64) @ H.astype(np.int64)
    return (score == hsum[None, :]).astype(np.float32)


@pytest.mark.parametrize("depth", range(1, 10))
def test_tree_gather_predicates_equal_pallas(depth):
    """The gather rule, with NaN, +Inf and -Inf at a node's feature column,
    elsewhere in the row and in whole rows, equals the reference's Pallas
    kernel (interpret mode), whose predicates are fp32 dots over k."""
    rng = np.random.default_rng(100 + depth)
    k = 6
    tree = random_tree(rng, k, depth)
    x = rng.normal(size=(40, k)).astype(np.float32)
    f0 = int(np.asarray(tree.F)[:, 0].argmax())
    other = (f0 + 1) % k
    for r, c, val in ((1, f0, np.nan), (2, f0, np.inf), (3, f0, -np.inf),
                      (4, other, np.nan), (5, other, np.inf),
                      (6, other, -np.inf), (7, f0, np.inf),
                      (7, other, -np.inf)):
        x[r, c] = val
    x[8] = np.nan
    x[9] = np.inf
    x[10] = -np.inf
    x[11, :] = [np.inf, -np.inf] * (k // 2)
    got = _gather_rule(x, tree)
    _, want = _tree_both(x, tree)
    np.testing.assert_array_equal(got, want)
    # the cases still reach the leaves one-hot, with a hit past the NaN rows
    assert (got.sum(axis=1) <= 1).all() and got[12:].sum() == len(x) - 12


def _bf16_round_trip(a):
    return torch.from_numpy(np.array(a, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def _registry_and_paper_trees():
    """Every tree of the reference's query registry, and the paper's widest
    (setting 1: k=128, depth 7; setting 2: k=512, depth 9)."""
    from repro.core.fusion import DecisionTreeGEMM as RefTreeOp
    from repro.data import QUERY_IR as REF_IR
    trees = [(name, REF_IR[name]().model) for name in sorted(REF_IR)
             if isinstance(REF_IR[name]().model, RefTreeOp)]
    trees += [("setting1", random_tree(np.random.default_rng(1), 128, 7)),
              ("setting2", random_tree(np.random.default_rng(2), 512, 9))]
    return [pytest.param(tree, id=name) for name, tree in trees]


@pytest.mark.parametrize("tree", _registry_and_paper_trees())
def test_tree_scores_exact_in_bf16(tree):
    """Predicates in {0, 1} and H in {-1, 0, 1} survive a round trip through
    bf16 unchanged, so the tensor-core scores (bf16 operands, fp32 sums of
    integers below 2**24) equal the fp32 product bit for bit."""
    H = np.asarray(tree.H, np.float32)
    assert set(np.unique(H)) <= {-1.0, 0.0, 1.0}
    np.testing.assert_array_equal(_bf16_round_trip(H), H)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(64, tree.k)).astype(np.float32)
    preds = ((x @ np.asarray(tree.F)) > np.asarray(tree.v)).astype(
        np.float32)
    np.testing.assert_array_equal(_bf16_round_trip(preds), preds)
    assert tree.p < 2**24
    want = preds.astype(np.float64) @ H.astype(np.float64)
    got = (torch.from_numpy(_bf16_round_trip(preds))
           @ torch.from_numpy(_bf16_round_trip(H))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.float32))
