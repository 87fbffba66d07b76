"""Port parity: the LAQ relational operators of ``tests/test_laq_ops.py``
(projection, selection, domains, MM-join and materialization here; the
group-by, sort, star-join and equivalence cases in
``tests/test_torch_laq_ops_b.py``), case by case, on ``repro_torch.core.laq``
against ``repro.core.laq`` and the numpy oracles of
``tests/helpers_relational.py``.

Each reference test has a test of the same name here.  The reference's
hypothesis properties become fixed lists of draws (no ``@given``): each
case builds its inputs from a numpy seed and feeds the same arrays to both
packages.  Tolerances:
  * exact — domains, positions, pointers, one-hot and 0/1 matrices, group
    codes, gathers and materialized rows, orderings, and sums of
    integer-valued data;
  * rtol 1e-6 / 1e-5 — float sums, where the reference's own test uses
    that tolerance (the two libraries add in different orders).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core.laq as R
import repro_torch.core.laq as T
from helpers_relational import np_equijoin_pairs
from torch_parity import to_np


def _t(a):
    """A port CPU tensor of numpy array ``a``."""
    return torch.from_numpy(np.ascontiguousarray(a))


def make_tables(rng, name, n, ncols, key_names=(), key_max=50,
                capacity=None):
    """(reference Table, port Table) of one random relation."""
    cols = {f"c{i}": rng.normal(size=n).astype(np.float32)
            for i in range(ncols)}
    for k in key_names:
        cols[k] = rng.integers(0, key_max, size=n)
    ref = R.Table.from_columns(name, cols, key_cols=key_names,
                               capacity=capacity)
    return ref, T.Table.from_columns(name, cols, key_cols=key_names,
                                     capacity=capacity, device="cpu")


def _same_table(got, want):
    assert got.name == want.name and tuple(got.columns) == tuple(want.columns)
    assert int(got.nvalid) == int(want.nvalid)
    np.testing.assert_array_equal(to_np(got.matrix), to_np(want.matrix))
    assert set(got.keys) == set(want.keys)
    for c in want.keys:
        np.testing.assert_array_equal(to_np(got.keys[c]), to_np(want.keys[c]))


# ---------------------------------------------------------------- projection
def test_projection_matmul_equals_gather():
    rng = np.random.default_rng(0)
    ref, t = make_tables(rng, "t", 17, 5)
    a = T.project_matmul(t, ["c3", "c0", "c4"])
    b = T.project_gather(t, ["c3", "c0", "c4"])
    np.testing.assert_allclose(to_np(a.matrix), to_np(b.matrix))
    assert a.columns == ("c3", "c0", "c4")
    _same_table(a, R.project_matmul(ref, ["c3", "c0", "c4"]))
    _same_table(b, R.project_gather(ref, ["c3", "c0", "c4"]))


def test_mapping_matrix_is_binary_column_selector():
    m = T.mapping_matrix(["a", "b", "c"], ["c", "a"])
    want = np.array([[0, 1], [0, 0], [1, 0]], np.float32)
    np.testing.assert_array_equal(to_np(m), want)
    np.testing.assert_array_equal(
        to_np(m), to_np(R.mapping_matrix(["a", "b", "c"], ["c", "a"])))


# ----------------------------------------------------------------- selection
def test_selection_vector_and_compaction():
    rng = np.random.default_rng(1)
    ref, t = make_tables(rng, "t", 40, 3, key_names=("k",), key_max=10,
                         capacity=64)
    preds = [T.Pred("c0", ">", 0.0), T.Pred("k", "<=", 5)]
    ref_preds = [R.Pred("c0", ">", 0.0), R.Pred("k", "<=", 5)]
    vec = to_np(T.selection_vector(t, preds))
    mat = to_np(t.matrix)
    k = to_np(t.key("k"))
    expect = ((mat[:, 0] > 0) & (k <= 5)
              & (np.arange(64) < 40)).astype(np.float32)
    np.testing.assert_array_equal(vec, expect)
    np.testing.assert_array_equal(vec, to_np(R.selection_vector(ref,
                                                                ref_preds)))

    out = T.select(t, preds, capacity=64)
    n = int(out.nvalid)
    assert n == int(expect.sum())
    np.testing.assert_allclose(to_np(out.matrix)[:n],
                               mat[expect.astype(bool)])
    assert np.all(to_np(out.matrix)[n:] == 0)
    assert np.all(to_np(out.key("k"))[n:] == T.PAD_KEY)
    _same_table(out, R.select(ref, ref_preds, capacity=64))


def test_selection_between_and_in():
    rng = np.random.default_rng(2)
    ref, t = make_tables(rng, "t", 30, 1, key_names=("k",), key_max=20)
    k = to_np(t.key("k"))
    m1 = to_np(T.Pred("k", "between", (5, 10)).mask(t))
    np.testing.assert_array_equal(m1, (k >= 5) & (k <= 10))
    m2 = to_np(T.Pred("k", "in", [3, 7, 19]).mask(t))
    np.testing.assert_array_equal(m2, np.isin(k, [3, 7, 19]))
    np.testing.assert_array_equal(
        m1, to_np(R.Pred("k", "between", (5, 10)).mask(ref)))
    np.testing.assert_array_equal(
        m2, to_np(R.Pred("k", "in", [3, 7, 19]).mask(ref)))


# -------------------------------------------------------------------- domain
def test_key_domain_sorted_union_with_padding():
    a = np.array([5, 1, 9, T.PAD_KEY], np.int32)
    b = np.array([9, 2], np.int32)
    dom = to_np(T.key_domain([_t(a), _t(b)], size=8))
    assert list(dom[:4]) == [1, 2, 5, 9]
    assert np.all(dom[4:] == T.PAD_KEY)
    np.testing.assert_array_equal(
        dom, to_np(R.key_domain([jnp.asarray(a), jnp.asarray(b)], size=8)))


def test_positions_miss_and_padding_out_of_range():
    dom = np.array([2, 4, 6, T.PAD_KEY], np.int32)
    keys = np.array([4, 3, T.PAD_KEY, 6], np.int32)
    pos = to_np(T.positions(_t(dom), _t(keys)))
    assert pos[0] == 1 and pos[3] == 2
    assert pos[1] == 4 and pos[2] == 4
    np.testing.assert_array_equal(
        pos, to_np(R.positions(jnp.asarray(dom), jnp.asarray(keys))))


# ------------------------------------------------------------------- MM-join
@pytest.mark.parametrize("seed,nr,ns,key_max", [
    (0, 1, 1, 2), (1, 24, 24, 12), (2, 7, 19, 3), (3, 20, 5, 8)])
def test_mmjoin_dense_matches_oracle(seed, nr, ns, key_max):
    rng = np.random.default_rng(seed)
    kr = rng.integers(0, key_max, size=nr).astype(np.int32)
    ks = rng.integers(0, key_max, size=ns).astype(np.int32)
    I = to_np(T.mmjoin_dense(_t(kr), _t(ks), domain_size=2 * key_max))
    got = {(i, j) for i, j in zip(*np.nonzero(I > 0.5))}
    assert got == np_equijoin_pairs(kr, ks)
    assert set(np.unique(I)) <= {0.0, 1.0}
    np.testing.assert_array_equal(
        I, to_np(R.mmjoin_dense(jnp.asarray(kr), jnp.asarray(ks),
                                domain_size=2 * key_max)))


def test_mmjoin_bcoo_matches_dense():
    rng = np.random.default_rng(7)
    kr = rng.integers(0, 15, size=20).astype(np.int32)
    ks = rng.integers(0, 15, size=10).astype(np.int32)
    d = to_np(T.mmjoin_dense(_t(kr), _t(ks), 32))
    b = to_np(T.mmjoin_bcoo(_t(kr), _t(ks), 32))
    np.testing.assert_allclose(d, b)
    np.testing.assert_array_equal(
        b, to_np(R.mmjoin_bcoo(jnp.asarray(kr), jnp.asarray(ks), 32)))


@pytest.mark.parametrize("seed,n_fact,n_dim", [
    (0, 1, 1), (1, 40, 20), (2, 17, 3), (3, 5, 20)])
def test_join_factored_pkfk_matches_oracle(seed, n_fact, n_dim):
    rng = np.random.default_rng(seed)
    pk = rng.permutation(n_dim * 3)[:n_dim].astype(np.int32)
    fk = rng.choice(np.concatenate([pk, np.arange(n_dim * 3, n_dim * 3 + 5)]),
                    size=n_fact).astype(np.int32)
    fj = T.join_factored(_t(fk), _t(pk))
    found, ptr = to_np(fj.found), to_np(fj.ptr)
    for i in range(n_fact):
        matches = np.nonzero(pk == fk[i])[0]
        assert found[i] == (len(matches) == 1)
        if found[i]:
            assert ptr[i] == matches[0]
    rj = R.join_factored(jnp.asarray(fk), jnp.asarray(pk))
    np.testing.assert_array_equal(found, to_np(rj.found))
    np.testing.assert_array_equal(ptr, to_np(rj.ptr))


def test_factored_dense_equals_mmjoin_dense():
    rng = np.random.default_rng(3)
    pk = rng.permutation(30)[:12].astype(np.int32)
    fk = rng.choice(np.concatenate([pk, [97, 98]]), size=25).astype(np.int32)
    fj = T.join_factored(_t(fk), _t(pk))
    dense_factored = to_np(fj.dense(12))
    np.testing.assert_allclose(dense_factored,
                               to_np(T.mmjoin_dense(_t(fk), _t(pk), 64)))
    np.testing.assert_array_equal(
        dense_factored,
        to_np(R.join_factored(jnp.asarray(fk), jnp.asarray(pk)).dense(12)))


def test_factored_apply_is_I_times_matrix():
    rng = np.random.default_rng(4)
    pk = np.arange(10, dtype=np.int32)
    fk = rng.integers(0, 14, size=20).astype(np.int32)
    x = rng.normal(size=(10, 3)).astype(np.float32)
    fj = T.join_factored(_t(fk), _t(pk))
    got = to_np(fj.apply(_t(x)))
    np.testing.assert_allclose(got, to_np(fj.dense(10)) @ x, rtol=1e-6)
    np.testing.assert_array_equal(
        got, to_np(R.join_factored(jnp.asarray(fk), jnp.asarray(pk)).apply(
            jnp.asarray(x))))


# ----------------------------------------------------------- materialization
def test_materialization_matmul_equals_gather():
    rng = np.random.default_rng(5)
    rr, r = make_tables(rng, "r", 15, 2, key_names=("k",), key_max=8)
    rs, s = make_tables(rng, "s", 12, 3, key_names=("k",), key_max=8)
    I = T.mmjoin_dense(r.key("k"), s.key("k"), 16)
    cap = 15 * 12
    a = T.materialize_matmul(I, r, s, cap)
    b = T.materialize_gather(I, r, s, cap)
    assert int(a.nvalid) == int(b.nvalid)
    n = int(a.nvalid)
    np.testing.assert_allclose(to_np(a.matrix)[:n], to_np(b.matrix)[:n],
                               rtol=1e-6)
    assert n == len(np_equijoin_pairs(to_np(r.key("k"))[:15],
                                      to_np(s.key("k"))[:12]))
    ref_I = R.mmjoin_dense(rr.key("k"), rs.key("k"), 16)
    np.testing.assert_array_equal(to_np(I), to_np(ref_I))
    for got, want in (
            (T.matching_pairs(I, cap), R.matching_pairs(ref_I, cap)),):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(to_np(g), to_np(w))
    # One-hot products and gathers copy rows: exact against the reference.
    _same_table(a, R.materialize_matmul(ref_I, rr, rs, cap))
    _same_table(b, R.materialize_gather(ref_I, rr, rs, cap))
    ii, jj, _ = T.matching_pairs(I, cap)
    for g, w in zip(T.row_mapping_matrices(ii, jj, 15, 12),
                    R.row_mapping_matrices(jnp.asarray(to_np(ii)),
                                           jnp.asarray(to_np(jj)), 15, 12)):
        np.testing.assert_array_equal(to_np(g), to_np(w))
