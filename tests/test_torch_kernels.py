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
from repro_torch.kernels.onehot_matmul.ops import (MAX_SLABS, NF_COLS,
                                                   OFFSET_LIMIT, THREADS,
                                                   Geometry, launch_geometry)
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



# ------------------------------------------- onehot_matmul's CUDA geometry
# The kernel's loops in numpy (csrc/onehot_matmul.cu), driven by the same
# launch_geometry the wrapper passes to the card.
_COUNT_UNROLL = 4      # OHM_UNROLL: 16-byte loads in flight per count thread
_UNITS_IN_FLIGHT = 4   # U of a one-row step


def _check_count_cover(geom, r, d, elem, offset):
    """The count kernel reads every table entry once: its slabs tile the
    rows; each slab's flat walk (a head up to the 16-byte boundary, 16-byte
    vectors tid + q·THREADS + it·UNROLL·THREADS, a tail) tiles the slab's
    entries; a flagged slab's 2-D walk ((TY rows) x (TX columns), a tile of
    NF_COLS columns at a time) covers each (row, column) once.  ``offset``:
    the table's first entry lies that many entries past a 16-byte
    boundary."""
    epv = 16 // elem
    rows = np.zeros(r, np.int64)
    tx = 1 << geom.count_lanes_log
    ty = THREADS >> geom.count_lanes_log
    for s in range(geom.slabs):
        row0 = s * geom.slab_rows
        row1 = min(r, row0 + geom.slab_rows)
        assert row0 < row1            # no empty slab
        length = (row1 - row0) * d
        start = offset + row0 * d
        head = min(((16 - start * elem % 16) % 16) // elem, length)
        nv = (length - head) // epv
        tail = length - head - nv * epv
        assert head < epv and tail < epv and max(head, tail) <= THREADS
        assert head == length or (start + head) * elem % 16 == 0
        j = (np.arange(THREADS)[:, None, None]
             + THREADS * np.arange(_COUNT_UNROLL)[None, :, None]
             + _COUNT_UNROLL * THREADS
             * np.arange(-(-nv // (_COUNT_UNROLL * THREADS)) or 1)[
                 None, None, :]).ravel()
        np.testing.assert_array_equal(
            np.bincount(j[j < nv], minlength=nv), np.ones(nv, np.int64))
        for y in range(ty):
            rows[row0 + y:row1:ty] += 1
    np.testing.assert_array_equal(rows, np.ones(r, np.int64))
    cols = np.zeros(d, np.int64)
    for c0 in range(0, d, NF_COLS):
        width = min(NF_COLS, d - c0)
        for x in range(tx):
            cols[c0 + x:c0 + width:tx] += 1
    np.testing.assert_array_equal(cols, np.ones(d, np.int64))


def _check_gather_cover(geom, n, d):
    """The gather writes every output element once: each row belongs to one
    group of lanes (block·rows_per_block·ROWS + group + q·rows_per_block +
    m·step: a block's rows of a step are contiguous), and each VEC-entry
    unit of a row to one lane of the group, in the all-finite loop (sub +
    j·G + it·U·G) and in the NaN rule's loop (tiles of U·G units, sub + j·G
    in each)."""
    vec = geom.gather_vec
    assert d % vec == 0
    units = d // vec
    lanes = 1 << geom.row_lanes_log
    rows_per_block = THREADS >> geom.row_lanes_log
    rows_per_step = geom.rows_per_step
    step = rows_per_step * geom.gather_blocks * rows_per_block
    first = (np.arange(geom.gather_blocks)[:, None] * rows_per_block
             * rows_per_step + np.arange(rows_per_block)[None, :]).ravel()
    rows = np.zeros(n, np.int64)
    for m in range(-(-n // step)):
        for q in range(rows_per_step):
            i = first + q * rows_per_block + m * step
            rows += np.bincount(i[i < n], minlength=n)
    np.testing.assert_array_equal(rows, np.ones(n, np.int64))
    u_per = _UNITS_IN_FLIGHT if geom.rows_per_step == 1 else 1
    plain = np.zeros(units, np.int64)
    rule = np.zeros(units, np.int64)
    for sub in range(lanes):
        for u0 in range(sub, units, u_per * lanes):
            u = u0 + lanes * np.arange(u_per)
            plain += np.bincount(u[u < units], minlength=units)
        for t0 in range(0, units, u_per * lanes):
            u = t0 + sub + lanes * np.arange(u_per)
            rule += np.bincount(u[u < min(t0 + u_per * lanes, units)],
                                minlength=units)
    np.testing.assert_array_equal(plain, np.ones(units, np.int64))
    np.testing.assert_array_equal(rule, np.ones(units, np.int64))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r", [1, 7, 513, 16384])
@pytest.mark.parametrize("d", [1, 3, 4, 5, 8, 129, 512, 2048])
def test_onehot_geometry_covers_once(d, r, dtype, aligned):
    """Every (row, column) of the table is counted once and every output
    element is written once, on the geometry's grid (about one pass over
    the rows) and on a 3-block grid (several grid-stride steps); 4-entry
    gathers only on aligned rows of d % 4 == 0, a warp at most per row, at
    most MAX_SLABS slabs, 32-bit row indices one step past the last row."""
    elem = 4 if dtype == "float32" else 2
    offset = 0 if aligned else 1     # a view one entry into its buffer
    n = 9000
    geom = launch_geometry(n, r, d, aligned)
    assert 1 <= geom.slabs <= min(MAX_SLABS, r)
    assert geom.gather_vec == (4 if aligned and d % 4 == 0 else 1)
    assert 0 <= geom.row_lanes_log <= 5 and geom.count_lanes_log <= 8
    assert not geom.wide
    _check_count_cover(geom, r, d, elem, offset)
    small = Geometry(*(getattr(geom, f) for f, _ in Geometry._fields_))
    small.gather_blocks = 3
    for g in (geom, small):
        rows_per_block = THREADS >> g.row_lanes_log
        step = g.rows_per_step * g.gather_blocks * rows_per_block
        assert n + step < 2**32
        _check_gather_cover(g, n, d)


def test_onehot_geometry_wide_switch():
    """Offsets turn 64-bit exactly when n·d or r·d reaches 2**31, and below
    that every row index one step past the last row stays in the range of
    unsigned (the CUDA entry point's own check: n + step < 2**32)."""
    lim = OFFSET_LIMIT
    assert lim == 2**31
    for n, r, d, wide in ((lim // 4 - 1, 5, 4, False), (lim // 4, 5, 4, True),
                          (5, lim // 4 - 1, 4, False), (5, lim // 4, 4, True),
                          (lim - 1, 1, 1, False), (lim, 1, 1, True),
                          (1, lim - 1, 1, False), (1, lim, 1, True),
                          (lim // 2, 3, 2, True), (3, lim // 2, 2, True)):
        geom = launch_geometry(n, r, d, True)
        assert bool(geom.wide) is wide, (n, r, d)
        assert (n * d >= lim or r * d >= lim) is wide
        rows_per_block = THREADS >> geom.row_lanes_log
        step = geom.rows_per_step * geom.gather_blocks * rows_per_block
        assert wide or n + step < 2 * lim


def _slab_model(tbl, geom):
    """The count kernel's outputs in numpy: each slab's flag, and the
    per-column counts of the flagged slabs only; nf is their sum."""
    bad = ~np.isfinite(tbl)
    flags, counts = [], {}
    for s in range(geom.slabs):
        block = bad[s * geom.slab_rows:(s + 1) * geom.slab_rows]
        flags.append(bool(block.any()))
        if flags[-1]:
            counts[s] = block.sum(axis=0)
    nf = sum(counts.values(), np.zeros(tbl.shape[1], np.int64))
    return np.array(flags), counts, nf


def _gather_model(idx, tbl, nf):
    """The gather's NaN rule: out = (nf - own > 0) ? NaN : entry (0 out of
    range), own = in range and the row's own entry is NaN or ±Inf."""
    r = tbl.shape[0]
    inr = (idx >= 0) & (idx < r)
    val = np.where(inr[:, None], tbl[np.clip(idx, 0, r - 1)], np.float32(0))
    own = inr[:, None] & ~np.isfinite(val)
    return np.where(nf[None, :] - own > 0, np.float32(np.nan), val)


def _slab_tables(case, bad, rng):
    """(idx, table): test_onehot_matmul_non_finite_tables' table (one slab),
    or a 20000-row table with non-finite entries in the first slab, a middle
    one and the last and a column whose one NaN no row selects ("slabs"),
    or with an all-NaN column ("nan column")."""
    if case == "reference":
        r, d = 9, 6
        tbl = rng.normal(size=(r, d)).astype(np.float32)
        tbl[2, 1] = bad
        tbl[4, 3] = bad
        tbl[6, 3] = np.nan
        return np.array([2, 4, 6, 0, -1, r, 2, 5], np.int32), tbl
    r, d = 20000, 6
    geom = launch_geometry(64, r, d, True)
    mid = (geom.slabs // 2) * geom.slab_rows + 3
    tbl = rng.normal(size=(r, d)).astype(np.float32)
    tbl[0, 1], tbl[mid, 3], tbl[r - 1, 1] = bad, bad, np.nan
    tbl[10, 2] = np.nan                       # selected by no row
    if case == "nan column":
        tbl[:, 5] = np.nan
    idx = rng.integers(11, r - 1, size=64).astype(np.int32)
    idx[:6] = [0, mid, r - 1, -1, r, -(2**31)]
    return idx, tbl


@pytest.mark.parametrize("case", ["reference", "slabs", "nan column"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_onehot_slab_counts_model(case, bad, dtype):
    """The slab flags and the flagged slabs' counts add up to each column's
    non-finite count, and through the own-entry rule give the jnp oracle's
    output, NaN in the same places."""
    idx, tbl = _slab_tables(case, bad, np.random.default_rng(3))
    tdt, jdt = _TORCH_DTYPES[dtype]
    exact = to_np(torch.from_numpy(tbl).to(tdt).to(torch.float32))
    geom = launch_geometry(len(idx), *tbl.shape, True)
    flags, counts, nf = _slab_model(exact, geom)
    np.testing.assert_array_equal(nf, (~np.isfinite(exact)).sum(axis=0))
    if case == "slabs":                 # rows 0 and 10, mid, r - 1
        assert geom.slabs >= 3
        np.testing.assert_array_equal(
            np.flatnonzero(flags), [0, geom.slabs // 2, geom.slabs - 1])
    if case == "nan column":
        assert flags.all()
    assert sorted(counts) == list(np.flatnonzero(flags))
    got = _gather_model(idx, exact, nf)
    want = to_np(ref_onehot_matmul_ref(jnp.asarray(idx),
                                       jnp.asarray(tbl, jdt)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, to_np(onehot_matmul(torch.from_numpy(idx),
                                 torch.from_numpy(tbl).to(tdt))))


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
