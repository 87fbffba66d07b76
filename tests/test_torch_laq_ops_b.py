"""Port parity, second half of ``tests/test_laq_ops.py``'s cases (group-by,
sort, star join and the join/aggregate equivalences; the first half is
``tests/test_torch_laq_ops.py``), case by case, on ``repro_torch.core.laq``
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
from helpers_relational import np_groupby_sum, np_star_join
from torch_parity import port_table, to_np


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


# -------------------------------------------------------------------- groupby
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_groupby_sum_matmul_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    nr, ns, key_max = 20, 8, 12
    kr = rng.integers(0, key_max, size=nr).astype(np.int32)
    vr = rng.integers(-5, 6, size=nr).astype(np.float32)
    ks = rng.permutation(key_max)[:ns].astype(np.int32)
    gs = rng.integers(0, 4, size=ns).astype(np.int32)
    grp, sums = T.groupby_sum_matmul(_t(kr), _t(vr), _t(ks), _t(gs),
                                     domain_size=2 * key_max, num_groups=6)
    want = np_groupby_sum(kr, vr, ks, gs)
    got = {int(g): float(s) for g, s in zip(to_np(grp), to_np(sums))
           if int(g) != T.PAD_KEY}
    for g, s in want.items():
        assert got.get(g, 0.0) == pytest.approx(s, rel=1e-5, abs=1e-4)
    for g, s in got.items():
        if g not in want:
            assert s == pytest.approx(0.0, abs=1e-4)
    rg, rs = R.groupby_sum_matmul(jnp.asarray(kr), jnp.asarray(vr),
                                  jnp.asarray(ks), jnp.asarray(gs),
                                  domain_size=2 * key_max, num_groups=6)
    np.testing.assert_array_equal(to_np(grp), to_np(rg))
    np.testing.assert_array_equal(to_np(sums), to_np(rs))  # integer data


def test_groupby_reduce_ops():
    codes = np.array([3, 1, 3, 1, 2, 2**31 - 1], np.int32)
    vals = np.array([1., 2., 3., 4., 5., 100.], np.float32)
    uniq, outs = T.groupby_reduce(_t(codes), [_t(vals)] * 5, num_groups=4,
                                  ops=("sum", "count", "min", "max", "mean"))
    s, c, mn, mx, mean = (to_np(o) for o in outs)
    u = to_np(uniq)
    assert list(u[:3]) == [1, 2, 3]
    np.testing.assert_allclose(s[:3], [6., 5., 4.])
    np.testing.assert_allclose(c[:3], [2., 1., 2.])
    np.testing.assert_allclose(mn[:3], [2., 5., 1.])
    np.testing.assert_allclose(mx[:3], [4., 5., 3.])
    np.testing.assert_allclose(mean[:3], [3., 5., 2.])
    ru, routs = R.groupby_reduce(jnp.asarray(codes), [jnp.asarray(vals)] * 5,
                                 num_groups=4,
                                 ops=("sum", "count", "min", "max", "mean"))
    np.testing.assert_array_equal(u, to_np(ru))
    for g, w in zip((s, c, mn, mx, mean), routs):
        np.testing.assert_array_equal(g, to_np(w))  # empty slot: 0 / ±inf


def test_composite_code_roundtrip():
    a = np.array([1, 2, 0], np.int32)
    b = np.array([4, 0, 9], np.int32)
    valid = np.array([True, True, True])
    code = T.composite_code([_t(a), _t(b)], [3, 10], _t(valid))
    da, db = T.decode_composite(code, [3, 10])
    np.testing.assert_array_equal(to_np(da), a)
    np.testing.assert_array_equal(to_np(db), b)
    np.testing.assert_array_equal(
        to_np(code), to_np(R.composite_code([jnp.asarray(a), jnp.asarray(b)],
                                            [3, 10], jnp.asarray(valid))))


# ----------------------------------------------------------------------- sort
def test_order_by_lexicographic_padding_last():
    rng = np.random.default_rng(6)
    ref, t = make_tables(rng, "t", 10, 2, capacity=16)
    out = T.order_by(t, ["c0", "c1"], descending=[False, True])
    m = to_np(out.matrix)[:10]
    keys = list(zip(m[:, 0], -m[:, 1]))
    assert keys == sorted(keys)
    assert np.all(to_np(out.matrix)[10:] == 0)
    _same_table(out, R.order_by(ref, ["c0", "c1"], descending=[False, True]))
    vals = np.array([5, 1, 9, 1, 3], np.int32)
    ranks = to_np(T.sorted_domain_order(_t(vals)))
    np.testing.assert_array_equal(
        ranks, to_np(R.sorted_domain_order(jnp.asarray(vals))))
    np.testing.assert_array_equal(np.sort(vals)[ranks], vals)


# ------------------------------------------------------------------ star join
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_star_join_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    n_fact = 30
    dims_np, fact_cols, specs, ref_specs = [], {}, [], []
    for d, (n_dim, ncols) in enumerate([(8, 2), (6, 3), (5, 2)]):
        pk = rng.permutation(n_dim * 2)[:n_dim].astype(np.int32)
        fm = rng.normal(size=(n_dim, ncols)).astype(np.float32)
        cols = {f"f{j}": fm[:, j] for j in range(ncols)}
        cols["pk"] = pk
        ref_dim = R.Table.from_columns(f"dim{d}", cols, key_cols=("pk",))
        fk = rng.choice(np.concatenate([pk, [99]]), size=n_fact)
        fact_cols[f"fk{d}"] = fk
        dims_np.append((pk, fm, fk))
        feats = tuple(f"f{j}" for j in range(ncols))
        specs.append(T.DimSpec(port_table(ref_dim), f"fk{d}", "pk", feats))
        ref_specs.append(R.DimSpec(ref_dim, f"fk{d}", "pk", feats))
    fact_cols["val"] = rng.normal(size=n_fact).astype(np.float32)
    keys = tuple(f"fk{d}" for d in range(3))
    ref_fact = R.Table.from_columns("fact", fact_cols, key_cols=keys)
    sj = T.star_join(port_table(ref_fact), specs)
    t_gather = to_np(sj.materialize())
    t_matmul = to_np(sj.materialize_matmul())
    np.testing.assert_allclose(t_gather, t_matmul, rtol=1e-5, atol=1e-5)
    rows, feats = np_star_join([d[2] for d in dims_np],
                               [(d[0], d[1]) for d in dims_np])
    valid = to_np(sj.row_valid)
    np.testing.assert_array_equal(np.nonzero(valid)[0], rows)
    if len(rows):
        np.testing.assert_allclose(t_gather[rows], feats, rtol=1e-5)
    assert np.all(t_gather[~valid] == 0)
    ref_sj = R.star_join(ref_fact, ref_specs)
    np.testing.assert_array_equal(valid, to_np(ref_sj.row_valid))
    np.testing.assert_array_equal(t_gather, to_np(ref_sj.materialize()))


# --------------------------------------- factored vs dense join equivalence
@pytest.mark.parametrize("seed,n_fact,n_dim,regime", [
    (0, 1, 1, "mix"), (1, 30, 12, "mix"), (3, 30, 12, "all_miss"),
    (4, 1, 1, "all_miss"), (5, 30, 12, "dup_fk")])
def test_join_factored_equals_mmjoin_dense_and_bcoo(seed, n_fact, n_dim,
                                                    regime):
    rng = np.random.default_rng(seed)
    pk = rng.permutation(n_dim * 3)[:n_dim].astype(np.int32)
    if regime == "all_miss":
        fk = rng.integers(n_dim * 3, n_dim * 3 + 7,
                          size=n_fact).astype(np.int32)
    elif regime == "dup_fk":
        fk = np.full(n_fact, pk[rng.integers(0, n_dim)], np.int32)
    else:
        pool = np.concatenate([pk, pk, [n_dim * 3 + 1]])
        fk = rng.choice(pool, size=n_fact).astype(np.int32)
    fk_p = np.concatenate([fk, [T.PAD_KEY, T.PAD_KEY]]).astype(np.int32)
    pk_p = np.concatenate([pk, [T.PAD_KEY]]).astype(np.int32)
    fj = T.join_factored(_t(fk_p), _t(pk_p))
    dense_factored = to_np(fj.dense(pk_p.shape[0]))
    dom = n_dim * 3 + 10
    dense_mm = to_np(T.mmjoin_dense(_t(fk_p), _t(pk_p), dom))
    np.testing.assert_array_equal(dense_factored, dense_mm)
    dense_bcoo = to_np(T.mmjoin_bcoo(_t(fk_p), _t(pk_p), dom))
    np.testing.assert_array_equal(dense_mm, dense_bcoo)
    assert np.all(dense_factored[-2:] == 0)
    assert np.all(dense_factored[:, -1] == 0)
    if regime == "all_miss":
        assert not to_np(fj.found).any()
    np.testing.assert_array_equal(
        dense_bcoo, to_np(R.mmjoin_bcoo(jnp.asarray(fk_p), jnp.asarray(pk_p),
                                        dom)))


# --------------------------------------- groupby segment ≡ matmul (Fig. 4)
@pytest.mark.parametrize("seed,nr,ns,pad_rows", [
    (0, 1, 1, False), (1, 30, 10, True), (3, 30, 10, False),
    (5, 1, 10, True)])
def test_groupby_sum_segment_equals_matmul(seed, nr, ns, pad_rows):
    rng = np.random.default_rng(seed)
    key_max = 16
    kr = rng.integers(0, key_max, size=nr).astype(np.int32)
    vr = rng.integers(-5, 6, size=nr).astype(np.float32)
    ks = rng.permutation(key_max)[:ns].astype(np.int32)
    gs = rng.integers(0, 4, size=ns).astype(np.int32)
    if pad_rows:
        kr = np.concatenate([kr, [T.PAD_KEY]]).astype(np.int32)
        vr = np.concatenate([vr, [123.0]]).astype(np.float32)
        ks = np.concatenate([ks, [T.PAD_KEY]]).astype(np.int32)
        gs = np.concatenate([gs, [T.PAD_GROUP]]).astype(np.int32)
    args = (_t(kr), _t(vr), _t(ks), _t(gs))
    grp_m, sums_m = T.groupby_sum_matmul(*args, domain_size=2 * key_max,
                                         num_groups=6)
    grp_s, sums_s = T.groupby_sum_segment(*args, domain_size=2 * key_max,
                                          num_groups=6)
    np.testing.assert_array_equal(to_np(grp_m), to_np(grp_s))
    np.testing.assert_allclose(to_np(sums_m), to_np(sums_s), rtol=1e-6,
                               atol=1e-5)
    ref_args = tuple(jnp.asarray(a) for a in (kr, vr, ks, gs))
    rg, rs = R.groupby_sum_segment(*ref_args, domain_size=2 * key_max,
                                   num_groups=6)
    np.testing.assert_array_equal(to_np(grp_s), to_np(rg))
    np.testing.assert_array_equal(to_np(sums_s), to_np(rs))  # integer data


@pytest.mark.parametrize("seed,n,width", [
    (0, 1, 1), (1, 40, 5), (3, 40, 1), (4, 40, 2)])
def test_code_aggregate_segment_equals_matmul(seed, n, width):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 9, size=n).astype(np.int32)
    codes[rng.random(n) < 0.2] = T.PAD_GROUP
    uniq, gid = T.groupby_codes(_t(codes), num_groups=12)
    vals1 = rng.integers(-4, 5, size=n).astype(np.float32)
    vals2 = rng.integers(-4, 5, size=(n, width)).astype(np.float32)
    ru, rgid = R.groupby_codes(jnp.asarray(codes), num_groups=12)
    np.testing.assert_array_equal(to_np(uniq), to_np(ru))
    np.testing.assert_array_equal(to_np(gid), to_np(rgid))
    for vals in (vals1, vals2):
        a = to_np(T.segment_aggregate(gid, _t(vals), 12))
        b = to_np(T.matmul_aggregate(gid, _t(vals), 12))
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(
            a, to_np(R.segment_aggregate(rgid, jnp.asarray(vals), 12)))
    live = codes != T.PAD_GROUP
    np.testing.assert_allclose(
        to_np(T.segment_aggregate(gid, _t(vals1), 12)).sum(),
        vals1[live].sum(), rtol=1e-6, atol=1e-4)
