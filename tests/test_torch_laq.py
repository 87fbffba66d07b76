"""Port parity: LAQ operators (``repro_torch.core.laq``) vs ``repro.core.laq``.

Inputs are numpy arrays from a seed, given to both packages (the port's
through ``repro_torch.interop``).  Tolerances:
  * exact — tables, generated columns, selection masks, PK indices,
    ``ptr``/``found``, validity, group codes and group ids, gathers and
    one-hot products (every value is a copy or a 0/1 selection);
  * rtol 1e-5 — float aggregates summed over rows (the two libraries add
    in different orders).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core.laq as R
import repro_torch.core.laq as T
from repro.data import generate_ssb as ref_generate_ssb
from repro.data import generate_star as ref_generate_star
from repro_torch.data import generate_ssb, generate_star
from torch_parity import port_table, to_np


def _ref_table(rng, name, n, ncols, key_names=(), key_max=50, capacity=None):
    cols = {f"c{i}": rng.normal(size=n).astype(np.float32)
            for i in range(ncols)}
    for k in key_names:
        cols[k] = rng.integers(0, key_max, size=n)
    return cols, R.Table.from_columns(name, cols, key_cols=key_names,
                                      capacity=capacity)


def _assert_tables_equal(got, want):
    assert got.name == want.name and tuple(got.columns) == tuple(want.columns)
    assert int(got.nvalid) == int(want.nvalid)
    np.testing.assert_array_equal(to_np(got.matrix), to_np(want.matrix))
    assert set(got.keys) == set(want.keys)
    for c in want.keys:
        assert got.keys[c].dtype == torch.int32
        np.testing.assert_array_equal(to_np(got.keys[c]), to_np(want.keys[c]))


# ------------------------------------------------------------------ tables
def test_from_columns_matches_reference():
    rng = np.random.default_rng(0)
    cols, want = _ref_table(rng, "t", 37, 4, ("k", "g"), capacity=50)
    got = T.Table.from_columns("t", cols, key_cols=("k", "g"), capacity=50,
                               device="cpu")
    _assert_tables_equal(got, want)
    np.testing.assert_array_equal(to_np(got.valid_mask()),
                                  to_np(want.valid_mask()))
    np.testing.assert_array_equal(to_np(got.col("c2")), to_np(want.col("c2")))
    assert got.key("k").dtype == torch.int32
    assert int(got.key("k")[-1]) == T.PAD_KEY == int(R.PAD_KEY)


def test_ssb_generator_matches_reference():
    want = ref_generate_ssb(sf=1, scale=0.0005, seed=5)
    got = generate_ssb(sf=1, scale=0.0005, seed=5, device="cpu")
    for name in ("lineorder", "part", "supplier", "customer", "date"):
        _assert_tables_equal(getattr(got, name), getattr(want, name))


def test_synthetic_generator_matches_reference():
    want = ref_generate_star(1, 1, 7, seed=3, scale=0.001)
    got = generate_star(1, 1, 7, seed=3, scale=0.001, device="cpu")
    assert (got.k, got.n_fact, got.dim_rows) == (want.k, want.n_fact,
                                                 want.dim_rows)
    _assert_tables_equal(got.star.fact, want.star.fact)
    for dg, dw in zip(got.star.dims, want.star.dims):
        _assert_tables_equal(dg.dim, dw.dim)
        assert dg.feature_cols == dw.feature_cols
    for jg, jw in zip(got.star.joins, want.star.joins):
        np.testing.assert_array_equal(to_np(jg.ptr), to_np(jw.ptr))
        np.testing.assert_array_equal(to_np(jg.found), to_np(jw.found))
    np.testing.assert_array_equal(to_np(got.star.row_valid),
                                  to_np(want.star.row_valid))


# --------------------------------------------------- projection / selection
def test_mapping_matrix():
    got = T.mapping_matrix(["a", "b", "c"], ["c", "a"])
    want = R.mapping_matrix(["a", "b", "c"], ["c", "a"])
    np.testing.assert_array_equal(to_np(got), to_np(want))


@pytest.mark.parametrize("preds,combine", [
    ([("c0", ">", 0.0), ("k", "<=", 5)], "and"),
    ([("k", "between", (2, 6)), ("g", "in", (1, 4, 9))], "and"),
    ([("k", "==", 3), ("c1", "<", -0.5)], "or"),
    ([("g", "!=", 7), ("c2", ">=", 0.25)], "and"),
    ([], "and"),
])
def test_selection_matches_reference(preds, combine):
    rng = np.random.default_rng(1)
    _, ref = _ref_table(rng, "t", 40, 3, ("k", "g"), key_max=10, capacity=64)
    port = port_table(ref)
    rp = [R.Pred(*p) for p in preds]
    tp = [T.Pred(*p) for p in preds]
    np.testing.assert_array_equal(
        to_np(T.selection_vector(port, tp, combine)),
        to_np(R.selection_vector(ref, rp, combine)))
    for p_t, p_r in zip(tp, rp):
        np.testing.assert_array_equal(to_np(p_t.mask(port)),
                                      to_np(p_r.mask(ref)))
    got = T.select(port, tp, capacity=32, combine=combine)
    want = R.select(ref, rp, capacity=32, combine=combine)
    _assert_tables_equal(got, want)


# ------------------------------------------------------------------- joins
def test_pk_index_probe_matches_reference():
    rng = np.random.default_rng(2)
    pk = np.full(40, R.PAD_KEY, np.int32)
    pk[:30] = rng.permutation(100)[:30]
    fk = rng.integers(0, 100, size=200).astype(np.int32)
    fk[::17] = R.PAD_KEY
    ref_idx = R.pk_index(jnp.asarray(pk))
    idx = T.pk_index(torch.from_numpy(pk))
    np.testing.assert_array_equal(to_np(idx.sorted_pk),
                                  to_np(ref_idx.sorted_pk))
    np.testing.assert_array_equal(to_np(idx.order), to_np(ref_idx.order))
    got = idx.probe(torch.from_numpy(fk))
    want = ref_idx.probe(jnp.asarray(fk))
    assert got.ptr.dtype == torch.int32 and got.found.dtype == torch.bool
    np.testing.assert_array_equal(to_np(got.ptr), to_np(want.ptr))
    np.testing.assert_array_equal(to_np(got.found), to_np(want.found))
    fj = T.join_factored(torch.from_numpy(fk), torch.from_numpy(pk))
    np.testing.assert_array_equal(to_np(fj.ptr), to_np(want.ptr))

    mat = rng.normal(size=(40, 3)).astype(np.float32)
    mat[5] = np.nan
    ref_fj = R.FactoredJoin(want.ptr, want.found)
    np.testing.assert_array_equal(to_np(got.apply(torch.from_numpy(mat))),
                                  to_np(ref_fj.apply(jnp.asarray(mat))))
    np.testing.assert_array_equal(to_np(got.dense(40)),
                                  to_np(ref_fj.dense(40)))


def test_dense_join_and_domain_match_reference():
    rng = np.random.default_rng(3)
    kr = rng.integers(0, 20, size=25).astype(np.int32)
    ks = np.full(16, R.PAD_KEY, np.int32)
    ks[:12] = rng.permutation(30)[:12]
    for size in (40, 8):
        np.testing.assert_array_equal(
            to_np(T.key_domain([torch.from_numpy(kr), torch.from_numpy(ks)],
                               size)),
            to_np(R.key_domain([jnp.asarray(kr), jnp.asarray(ks)], size)))
    dom = R.key_domain([jnp.asarray(kr), jnp.asarray(ks)], 40)
    np.testing.assert_array_equal(
        to_np(T.positions(torch.from_numpy(np.array(dom)),
                          torch.from_numpy(ks))),
        to_np(R.positions(dom, jnp.asarray(ks))))
    np.testing.assert_array_equal(
        to_np(T.onehot_keys(torch.from_numpy(ks),
                            torch.from_numpy(np.array(dom)))),
        to_np(R.onehot_keys(jnp.asarray(ks), dom)))
    np.testing.assert_array_equal(
        to_np(T.mmjoin_dense(torch.from_numpy(kr), torch.from_numpy(ks), 40)),
        to_np(R.mmjoin_dense(jnp.asarray(kr), jnp.asarray(ks), 40)))


def test_star_join_matches_reference():
    rng = np.random.default_rng(4)
    _, fact = _ref_table(rng, "f", 60, 2, ("fa", "fb"), key_max=25,
                         capacity=64)
    _, da = _ref_table(rng, "a", 20, 3, ("pk",), key_max=1)
    _, db = _ref_table(rng, "b", 25, 2, ("pk",), key_max=1)
    da = R.Table.from_columns("a", {**{f"c{i}": np.asarray(da.matrix)[:, i]
                                       for i in range(3)},
                                    "pk": np.arange(20)}, key_cols=("pk",))
    db = R.Table.from_columns("b", {**{f"c{i}": np.asarray(db.matrix)[:, i]
                                       for i in range(2)},
                                    "pk": np.arange(25)}, key_cols=("pk",))
    ref_dims = [R.DimSpec(da, "fa", "pk", ("c2", "c0")),
                R.DimSpec(db, "fb", "pk", ("c1",))]
    dims = [T.DimSpec(port_table(d.dim), d.fk_col, d.pk_col, d.feature_cols)
            for d in ref_dims]
    want = R.star_join(fact, ref_dims)
    got = T.star_join(port_table(fact), dims)
    np.testing.assert_array_equal(to_np(got.row_valid), to_np(want.row_valid))
    np.testing.assert_array_equal(to_np(got.materialize()),
                                  to_np(want.materialize()))
    np.testing.assert_array_equal(to_np(got.materialize_matmul()),
                                  to_np(want.materialize_matmul()))
    for g, w in zip(got.mapping_matrices(), want.mapping_matrices()):
        np.testing.assert_array_equal(to_np(g), to_np(w))
    ptrs, founds = T.stack_joins(got.joins)
    assert ptrs.dtype == torch.int32 and founds.dtype == torch.bool
    assert tuple(ptrs.shape) == (2, 64) and ptrs.is_contiguous()
    np.testing.assert_array_equal(to_np(ptrs[1]), to_np(want.joins[1].ptr))


# ------------------------------------------------------------- aggregation
def _codes(rng, n, bounds, live=0.8):
    cols = [rng.integers(0, b, size=n).astype(np.int32) for b in bounds]
    valid = rng.random(n) < live
    return cols, valid


def test_group_codes_and_ids_match_reference():
    rng = np.random.default_rng(5)
    cols, valid = _codes(rng, 300, (7, 5, 3))
    want = R.composite_code([jnp.asarray(c) for c in cols], (7, 5, 3),
                            jnp.asarray(valid))
    got = T.composite_code([torch.from_numpy(c) for c in cols], (7, 5, 3),
                           torch.from_numpy(valid))
    np.testing.assert_array_equal(to_np(got), to_np(want))
    for g in (105, 200):
        gu, gg = T.groupby_codes(got, g)
        wu, wg = R.groupby_codes(want, g)
        np.testing.assert_array_equal(to_np(gu), to_np(wu))
        np.testing.assert_array_equal(to_np(gg), to_np(wg))
    assert T.auto_num_groups(got) == R.auto_num_groups(want)
    with pytest.raises(ValueError, match="overflow"):
        T.groupby_codes(got, 10)
    live = to_np(got)[to_np(got) != T.PAD_GROUP]
    for g, w in zip(T.decode_composite(torch.from_numpy(live), (7, 5, 3)),
                    R.decode_composite(jnp.asarray(live), (7, 5, 3))):
        np.testing.assert_array_equal(to_np(g), to_np(w))


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("width", [None, 3])
def test_segment_reduce_matches_reference(op, width):
    rng = np.random.default_rng(6)
    n, G = 500, 16
    gid = rng.integers(0, G + 1, size=n).astype(np.int32)
    gid[gid == 5] = G            # one group receives no row
    shape = (n,) if width is None else (n, width)
    vals = rng.normal(size=shape).astype(np.float32)
    got = to_np(T.segment_reduce(torch.from_numpy(gid),
                                 torch.from_numpy(vals), G, op))
    want = to_np(R.segment_reduce(jnp.asarray(gid), jnp.asarray(vals), G, op))
    if op == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)
    if op == "sum":
        np.testing.assert_allclose(
            to_np(T.segment_aggregate(torch.from_numpy(gid),
                                      torch.from_numpy(vals), G)),
            want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            to_np(T.matmul_aggregate(torch.from_numpy(gid),
                                     torch.from_numpy(vals), G)),
            to_np(R.matmul_aggregate(jnp.asarray(gid), jnp.asarray(vals), G)),
            rtol=1e-5, atol=1e-5)


def test_integer_aggregates_are_exact():
    """Integer-valued data sums exactly on both aggregation backends."""
    rng = np.random.default_rng(7)
    gid = rng.integers(0, 9, size=400).astype(np.int32)
    vals = rng.integers(0, 5, size=(400, 4)).astype(np.float32)
    want = to_np(R.segment_aggregate(jnp.asarray(gid), jnp.asarray(vals), 8))
    for fn in (T.segment_aggregate, T.matmul_aggregate):
        np.testing.assert_array_equal(
            to_np(fn(torch.from_numpy(gid), torch.from_numpy(vals), 8)), want)
