"""Shared helpers for the port's parity tests (``tests/test_torch_*.py``).

Data crosses between the JAX package and the port only as numpy arrays,
through ``repro_torch.interop``; every port object here lives on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import torch

import repro.core.query as RQ
from repro.core.fusion import DecisionTreeGEMM as RefTree
from repro.core.fusion import LinearOperator as RefLinear
from repro.core.fusion import random_tree as ref_random_tree
from repro.core.laq import Catalog as RefCatalog
from repro.core.laq import Table as RefTable
from repro.core.laq.selection import Pred as RefPred
from repro.data import QUERY_IR as REF_QUERY_IR
from repro.data import generate_ssb as ref_generate_ssb
from repro.data import ssb_catalog
from repro_torch.core.laq import PAD_KEY, Pred
from repro_torch.core.query import (Aggregate, ArmSpec, ChainLink, GroupKey,
                                    PredictionFilter, PredictiveQuery,
                                    compile_query)
from repro_torch.data import QUERY_IR
from repro_torch.interop import (catalog_from_tables, model_from_arrays,
                                 table_from_arrays)


def to_np(x):
    """numpy view of a torch tensor or jax array (None passes through)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def port_table(ref_table):
    """The port's copy of a reference ``Table`` (same arrays and tombstones,
    on the CPU)."""
    deleted = getattr(ref_table, "deleted", None)
    return table_from_arrays(
        ref_table.name, ref_table.columns, np.asarray(ref_table.matrix),
        {c: np.asarray(k) for c, k in ref_table.keys.items()},
        int(ref_table.nvalid), device="cpu",
        deleted=None if deleted is None else np.asarray(deleted))


def port_tables(ref_catalog):
    return {name: port_table(t) for name, t in ref_catalog.items()}


def port_catalog(ref_catalog):
    """The port's copy of a reference ``Catalog``: its tables at their
    versions, writable unless the reference's is read-only."""
    return catalog_from_tables(
        port_tables(ref_catalog),
        {n: ref_catalog.version(n) for n in ref_catalog},
        read_only=ref_catalog.read_only)


def port_model(ref_model):
    """The port's copy of a reference model head."""
    if hasattr(ref_model, "L"):
        bias = None if ref_model.bias is None else np.asarray(ref_model.bias)
        return model_from_arrays("linear", L=np.asarray(ref_model.L),
                                 bias=bias)
    return model_from_arrays("tree", F=np.asarray(ref_model.F),
                             v=np.asarray(ref_model.v),
                             H=np.asarray(ref_model.H),
                             h=np.asarray(ref_model.h))


def port_query(ref_q):
    """The port's copy of a reference ``PredictiveQuery``: arms with their
    snowflake links, predicates, model head and prediction filters."""
    def preds(ps):
        return tuple(Pred(p.col, p.op, p.value) for p in ps)

    def links(lks):
        return tuple(ChainLink(lk.table, lk.fk_col, lk.pk_col,
                               tuple(lk.feature_cols), preds(lk.preds),
                               lk.parent) for lk in lks)

    return PredictiveQuery(
        fact=ref_q.fact,
        arms=tuple(ArmSpec(a.table, a.fk_col, a.pk_col,
                           tuple(a.feature_cols), preds(a.preds),
                           links(a.links))
                   for a in ref_q.arms),
        fact_preds=preds(ref_q.fact_preds),
        model=None if ref_q.model is None else port_model(ref_q.model),
        group_keys=tuple(GroupKey(g.table, g.col, g.bound, g.offset)
                         for g in ref_q.group_keys),
        aggregates=tuple(Aggregate(a.value, a.op, a.name)
                         for a in ref_q.aggregates),
        num_groups=ref_q.num_groups,
        model_preds=tuple(PredictionFilter(f.output, f.op, f.value)
                          for f in ref_q.model_preds))


# ------------------------------------------------------------ query parity
def ref_ssb_catalog():
    """The reference's SSB catalog at the parity tests' size."""
    return ssb_catalog(ref_generate_ssb(sf=1, scale=0.0005, seed=5))


def ref_plan(cache, ref_cat, name, **kw):
    """The reference's ``rewrite="off"`` plan, compiled once per option set
    (Pallas kernels in interpret mode, as its own tests run them)."""
    key = (name, tuple(sorted(kw.items())))
    if key not in cache:
        cache[key] = RQ.compile_query(ref_cat, REF_QUERY_IR[name](),
                                      rewrite="off", interpret=True, **kw)
    return cache[key]


def is_tree(name):
    return isinstance(REF_QUERY_IR[name]().model, RefTree)


def assert_run_equal(got, want, exact):
    """``run()`` results: rows and groups exact; aggregates exact for
    integer-valued (tree-head) sums, else rtol 1e-5 with atol 1e-5 of the
    aggregate's largest magnitude (row sums in another order)."""
    assert int(got["rows"]) == int(want["rows"])
    assert set(got) == set(want)
    if "groups" in want:
        np.testing.assert_array_equal(to_np(got["groups"]),
                                      to_np(want["groups"]))
    for k in want:
        if k in ("rows", "groups"):
            continue
        g, w = to_np(got[k]), to_np(want[k])
        assert g.shape == w.shape, k
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=1e-5 * max(np.abs(w).max(), 1.0),
                                       err_msg=k)


def assert_preds_equal(got, want, exact):
    """Prediction matrices: exact for tree heads; rtol 1e-6 (1 ulp) for
    linear heads with atol 1e-6 of the matrix's largest magnitude, since a
    fused row sums partials that each carry their own ulp."""
    g, w = to_np(got), to_np(want)
    assert g.shape == w.shape and g.dtype == np.float32
    if exact:
        np.testing.assert_array_equal(g, w)
    else:
        scale = np.nanmax(np.abs(w), initial=1.0)
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * scale)


def check_predictive_case(name, backend, join, agg, serve, tables, ref_cat,
                          ref_plans):
    """One P-query plan of the backend matrix against the reference:
    ``run()``, ``predictions()``, and ``predict_rows`` on in-range ids
    (against the same reference serve backend) and out-of-range ids
    (against the reference's plain ``jnp`` backend only)."""
    port_serve, ref_serve = serve
    kw = dict(backend=backend, join_backend=join, agg_backend=agg)
    want = ref_plan(ref_plans, ref_cat, name, serve_backend=ref_serve, **kw)
    got = compile_query(tables, QUERY_IR[name](), serve_backend=port_serve,
                        **kw)
    tree = is_tree(name)
    expect_serve = ("kernel" if port_serve == "kernel"
                    and (backend == "fused" or tree) else "torch")
    assert got.serve_backend == expect_serve
    assert_run_equal(got.run(), want.run(), exact=tree)
    assert_preds_equal(got.predictions(), want.predictions(), exact=tree)

    n = ref_cat["lineorder"].capacity
    inside = np.array([0, 1, 7, n - 1, -1, -n, n // 2], np.int32)
    assert_preds_equal(got.predict_rows(torch.from_numpy(inside)),
                       want.predict_rows(jnp.asarray(inside)), exact=tree)
    outside = np.array([n, n + 5, -n - 1, 3, 10**6], np.int32)
    # The reference's predict_rows reads neither the join nor the
    # aggregation backend, so one plain plan per (query, backend) serves.
    plain = (want if ref_serve == "jnp" else
             ref_plan(ref_plans, ref_cat, name, serve_backend="jnp",
                      backend=backend, join_backend="gather",
                      agg_backend="segment"))
    out = got.predict_rows(torch.from_numpy(outside))
    assert_preds_equal(out, plain.predict_rows(jnp.asarray(outside)),
                       exact=tree)
    if not tree:
        assert np.isnan(to_np(out)[[0, 1, 2, 4]]).all()


# --------------------------------------------------------- lifecycle parity
# The reference's 2-arm star of tests/test_incremental.py and
# tests/test_outofcore.py, mutated in step in both packages.
def ref_star(seed: int, n_d1: int = 24, n_d2: int = 10, n_fact: int = 64,
             slack: int = 16) -> RefCatalog:
    """The reference's 2-arm star (``test_incremental.star_catalog``):
    dimension capacity with slack for appends to land in."""
    rng = np.random.default_rng(seed)
    d1 = {"pk": np.arange(n_d1) * 2,      # sparse keys: FKs can miss
          "a": rng.normal(size=n_d1), "b": rng.normal(size=n_d1)}
    d2 = {"pk2": np.arange(n_d2), "c": rng.normal(size=n_d2),
          "g": rng.integers(0, 4, n_d2)}
    f = {"fk1": rng.integers(0, 2 * (n_d1 + slack), n_fact),
         "fk2": rng.integers(0, n_d2 + slack // 2, n_fact),
         "val": rng.normal(size=n_fact)}
    return RefCatalog({
        "d1": RefTable.from_columns("d1", d1, key_cols=("pk",),
                                    capacity=n_d1 + slack),
        "d2": RefTable.from_columns("d2", d2, key_cols=("pk2", "g"),
                                    capacity=n_d2 + slack),
        "fact": RefTable.from_columns("fact", f, key_cols=("fk1", "fk2"),
                                      capacity=n_fact + slack),
    })


def d1_rows(rng, m, start):
    return {"pk": start * 2 + 1 + 2 * np.arange(m),   # odd keys: fresh
            "a": rng.normal(size=m), "b": rng.normal(size=m)}


def d2_rows(rng, m, start):
    return {"pk2": start + np.arange(m), "c": rng.normal(size=m),
            "g": rng.integers(0, 4, m)}


class Both:
    """One reference catalog and its port copy, mutated in step."""

    def __init__(self, ref: RefCatalog):
        self.ref = ref
        self.port = port_catalog(ref)

    def _both(self, op, *args, **kw):
        want = getattr(self.ref, op)(*args, **kw)
        got = getattr(self.port, op)(*args, **kw)
        assert got == want, (op, got, want)
        return got

    def append(self, name, rows, **kw):
        return self._both("append", name, rows, **kw)

    def update_column(self, name, col, ids, vals):
        return self._both("update_column", name, col, ids, vals)

    def delete_rows(self, name, ids):
        return self._both("delete_rows", name, ids)

    def compact(self, name, **kw):
        return self._both("compact", name, **kw)


def ref_query(model, group: bool, extra_aggs: bool = False):
    """``test_incremental._query`` (and ``test_outofcore._query``'s extra
    aggregates)."""
    gk = (RQ.GroupKey("d2", "g", 4),) if group else ()
    aggs = [RQ.Aggregate(RQ.PREDICTION, "sum", "pred"),
            RQ.Aggregate("val", "mean", "v"),
            RQ.Aggregate("*", "count", "n")]
    if extra_aggs:
        aggs += [RQ.Aggregate("val", "min", "vmin"),
                 RQ.Aggregate("val", "max", "vmax"),
                 RQ.Aggregate(("mul", "val", "val"), "sum", "v2")]
    return RQ.PredictiveQuery(
        fact="fact",
        arms=(RQ.ArmSpec("d1", "fk1", "pk", ("a", "b"),
                         (RefPred("a", ">", -1.0),)),
              RQ.ArmSpec("d2", "fk2", "pk2", ("c",))),
        fact_preds=(RefPred("val", ">", -2.0),),
        model=model, group_keys=gk, aggregates=tuple(aggs),
        num_groups=4 if group else 8192)


def ref_models(seed=0):
    """A reference linear head and depth-2 tree over 3 features."""
    rng = np.random.default_rng(seed)
    return [RefLinear(jnp.asarray(
        rng.normal(size=(3, 2)).astype(np.float32))),
        ref_random_tree(rng, 3, depth=2)]


def ref_is_tree(ref_q):
    return not isinstance(ref_q.model, RefLinear)


def ref_compile(cat, q, **kw):
    return RQ.compile_query(cat, q, rewrite="off", **kw)


def assert_same(a, b):
    """Bit-for-bit equality of two port results (dicts or tensors)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(to_np(a[k]), to_np(b[k]),
                                          err_msg=k)
    else:
        np.testing.assert_array_equal(to_np(a), to_np(b))


def assert_partials_same(a, b):
    """The prefused partials of two port plans (or None), bit for bit."""
    if a is None or b is None:
        assert a is None and b is None
        return
    for pa, pb in zip(a.partials, b.partials):
        assert_same(pa, pb)


def assert_run_like_ref(got, want, tree):
    """``run()`` against the reference: rows, groups and counts exact, the
    prediction sum exact for tree heads, the rest rtol 1e-5 with atol 1e-5
    of the largest magnitude."""
    assert set(got) == set(want)
    for k in want:
        g, w = to_np(got[k]), to_np(want[k])
        assert g.shape == w.shape, k
        if k in ("rows", "groups", "n") or (tree and k == "pred"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(
                g, w, rtol=1e-5, atol=1e-5 * max(np.abs(w).max(initial=0),
                                                 1.0), err_msg=k)


def check_plan(got, want_ref, cold, ref_q, ids=None):
    """A refreshed port plan against the reference's refreshed plan and
    the port's cold compile."""
    tree = ref_is_tree(ref_q)
    assert_same(got.run(), cold.run())
    assert_run_like_ref(got.run(), want_ref.run(), tree)
    assert_partials_same(got.prefused, cold.prefused)
    if ids is not None:
        assert_same(got.predict_rows(torch.from_numpy(ids)),
                    cold.predict_rows(torch.from_numpy(ids)))
        assert_preds_equal(got.predict_rows(torch.from_numpy(ids)),
                           want_ref.predict_rows(jnp.asarray(ids)),
                           exact=tree)


def check_runtime(got, want_ref, cold, ref_q, reqs):
    tree = ref_is_tree(ref_q)
    assert_same(got.serve(reqs), cold.serve(reqs))
    assert_preds_equal(got.serve(reqs), want_ref.serve(reqs), exact=tree)
    for a, b in zip(got._arms, cold._arms):
        assert_same(a.table, b.table)
        assert_same(a.dmask, b.dmask)
        assert_same(a.index.sorted_pk, b.index.sorted_pk)
        assert_same(a.index.order, b.index.order)




# ------------------------------------------------------------- fuzz parity
#: The fuzz seeds among 0–499 whose generated query has a chained arm
#: (``repro.core.query.workload.generate_case``); the flat ones are
#: ``test_torch_fuzz.SEEDS``.
CHAIN_SEEDS = (
    0, 1, 3, 4, 5, 6, 7, 8, 10, 11, 13, 16, 17, 19, 22, 25, 28, 29, 30,
    37, 41, 45, 49, 50, 52, 53, 54, 55, 56, 57, 58, 59, 61, 62, 63, 65,
    67, 68, 69, 71, 72, 73, 74, 76, 77, 79, 81, 82, 83, 84, 85, 87, 88,
    91, 92, 93, 94, 95, 96, 97, 99, 101, 103, 105, 106, 107, 110, 112,
    115, 116, 117, 118, 119, 121, 123, 124, 125, 126, 127, 128, 131, 133,
    134, 135, 140, 142, 144, 145, 147, 149, 153, 154, 155, 159, 161, 162,
    163, 164, 165, 167, 169, 170, 173, 174, 176, 178, 180, 182, 183, 185,
    187, 188, 189, 193, 197, 199, 201, 203, 204, 205, 208, 209, 210, 211,
    215, 217, 218, 219, 220, 222, 223, 226, 227, 228, 230, 232, 233, 235,
    236, 239, 242, 243, 244, 248, 249, 250, 252, 253, 254, 255, 258, 261,
    262, 263, 264, 267, 269, 270, 271, 272, 275, 276, 277, 278, 279, 280,
    281, 282, 284, 286, 288, 293, 294, 295, 296, 297, 300, 302, 305, 307,
    309, 310, 312, 313, 314, 316, 317, 318, 319, 320, 323, 325, 326, 327,
    330, 331, 332, 335, 336, 339, 346, 348, 349, 351, 352, 354, 355, 357,
    358, 361, 363, 364, 365, 368, 369, 370, 371, 373, 376, 377, 378, 379,
    380, 382, 383, 385, 389, 390, 392, 393, 394, 395, 397, 398, 402, 403,
    404, 407, 409, 410, 413, 415, 416, 419, 421, 422, 423, 424, 425, 426,
    430, 431, 432, 433, 434, 435, 436, 437, 438, 439, 440, 442, 443, 445,
    448, 449, 450, 451, 453, 454, 455, 456, 457, 459, 460, 462, 463, 464,
    465, 466, 467, 468, 470, 471, 475, 479, 480, 481, 482, 483, 484, 485,
    487, 488, 490, 491, 492, 493, 494, 496, 498, 499,
)


def assert_case_equal(case, ref_case):
    """The port's ``generate_case(seed)`` against the reference's: the same
    tables (arrays, keys, live rows) and the same query, by content."""
    assert case.seed == ref_case.seed
    assert set(case.tables) == set(ref_case.tables)
    for name, t in case.tables.items():
        r = ref_case.tables[name]
        assert (t.name, t.columns, int(t.nvalid)) == (
            r.name, tuple(r.columns), int(r.nvalid))
        np.testing.assert_array_equal(to_np(t.matrix), np.asarray(r.matrix))
        assert set(t.keys) == set(r.keys)
        for c in t.keys:
            np.testing.assert_array_equal(to_np(t.key(c)),
                                          np.asarray(r.key(c)))
    assert case.query == port_query(ref_case.query)


def rewrite_leg(tables, q, ref_tables, ref_q, label):
    """The rewrite on/off leg of a fuzz case: the port's rewrite equals the
    reference's (trail, and IR by content), and the port's
    ``rewrite="off"`` plans equal the oracle under fused and nonfused
    (the default plans, rewritten, are checked by the caller).  Returns
    mismatch strings."""
    from repro_torch.core.query import Catalog, rewrite_query
    from repro_torch.core.query.workload import _compare, np_oracle
    rw = rewrite_query(tables, q)
    ref_rw = RQ.rewrite_query(ref_tables, ref_q)
    assert rw.trail == ref_rw.trail, (label, rw.trail, ref_rw.trail)
    assert rw.query == port_query(ref_rw.query), label
    want = np_oracle(tables, q)
    bad = []
    for backend in ("fused", "nonfused"):
        off = compile_query(Catalog(dict(tables)), q, backend=backend,
                            rewrite="off")
        assert off._rewrites == ()
        bad += _compare(off.run(), want, q, f"{label} rewrite=off/{backend}")
    return bad


def check_chain_seed(i):
    """Chained fuzz seed ``CHAIN_SEEDS[i]``: the port's generator equals
    the reference's, the port's ``check_case`` finds no mismatch (the full
    matrix on every 4th index, as ``run_fuzz`` does), and the rewrite leg."""
    from repro.core.query.workload import generate_case as ref_generate_case
    from repro_torch.core.query.workload import check_case, generate_case
    seed = CHAIN_SEEDS[i]
    case = generate_case(seed, device="cpu")
    ref_case = ref_generate_case(seed)
    assert_case_equal(case, ref_case)
    bad = check_case(seed, full=(i % 4 == 0), device="cpu")
    bad += rewrite_leg(case.tables, case.query, ref_case.tables,
                       ref_case.query, f"seed={seed}")
    assert not bad, "\n".join(bad[:10])


# --------------------------------------------------------- streaming parity
# tests/test_outofcore.py's star, query and oracle, for
# tests/test_torch_streaming.py and tests/test_torch_streaming_b.py.

#: The in-core program streaming must equal bit for bit: the auto planner
#: may aggregate small groups by one-hot matmul, a different program.
STREAM_PINNED = dict(backend="fused", join_backend="gather",
                     agg_backend="segment")
STREAM_KEYS = ("pred", "pmean", "v", "n")
STREAM_EXTRA = STREAM_KEYS + ("vmin", "vmax", "v2")


def stream_star(seed: int, n_fact: int = 640, slack: int = 16) -> Both:
    """``test_outofcore.star_catalog`` in both packages."""
    return Both(ref_star(seed, n_fact=n_fact, slack=slack))


def stream_model(seed: int = 1) -> RefLinear:
    """``test_outofcore._model``: the reference's linear head."""
    rng = np.random.default_rng(seed)
    return RefLinear(jnp.asarray(rng.normal(size=(3, 2)), jnp.float32))


def stream_query(model, *, group: bool = True, extra_aggs: bool = False):
    """``test_outofcore._query`` (the reference's IR)."""
    gk = (RQ.GroupKey("d2", "g", 4),) if group else ()
    aggs = [RQ.Aggregate(RQ.PREDICTION, "sum", "pred"),
            RQ.Aggregate(RQ.PREDICTION, "mean", "pmean"),
            RQ.Aggregate("val", "mean", "v"),
            RQ.Aggregate("*", "count", "n")]
    if extra_aggs:
        aggs += [RQ.Aggregate("val", "min", "vmin"),
                 RQ.Aggregate("val", "max", "vmax"),
                 RQ.Aggregate(("mul", "val", "val"), "sum", "v2")]
    return RQ.PredictiveQuery(
        fact="fact",
        arms=(RQ.ArmSpec("d1", "fk1", "pk", ("a", "b"),
                         (RefPred("a", ">", -1.0),)),
              RQ.ArmSpec("d2", "fk2", "pk2", ("c",))),
        fact_preds=(RefPred("val", ">", -2.0),),
        model=model, group_keys=gk, aggregates=tuple(aggs),
        num_groups=4 if group else 8192)


def assert_bitwise(got, want, keys):
    for k in keys:
        np.testing.assert_array_equal(to_np(got[k]), to_np(want[k]),
                                      err_msg=k)


def stream_oracle(cat, L: np.ndarray, *, group: bool = True):
    """Float64 row-at-a-time evaluation of the query over the port
    catalog's live rows, indexed by the raw group value ``g``."""
    fact, d1, d2 = cat["fact"], cat["d1"], cat["d2"]

    def live(t):
        m = np.arange(t.capacity) < int(t.nvalid)
        if t.deleted is not None:
            m &= ~to_np(t.deleted)
        return m

    def lookup(t, pk_col):
        alive = live(t)
        return {int(k): i for i, k in enumerate(to_np(t.key(pk_col)))
                if alive[i]}

    idx1, idx2 = lookup(d1, "pk"), lookup(d2, "pk2")
    a, b = (to_np(d1.col(c)).astype(np.float64) for c in ("a", "b"))
    c = to_np(d2.col("c")).astype(np.float64)
    g = to_np(d2.key("g")).astype(np.int64)
    val = to_np(fact.col("val")).astype(np.float64)
    fk1, fk2 = to_np(fact.key("fk1")), to_np(fact.key("fk2"))
    L = np.asarray(L, np.float64)
    G = 4 if group else 1
    pred, v, count = np.zeros((G, 2)), np.zeros(G), np.zeros(G)
    flive = live(fact)
    for i in range(int(fact.nvalid)):
        if not flive[i] or not val[i] > -2.0:
            continue
        j1, j2 = idx1.get(int(fk1[i])), idx2.get(int(fk2[i]))
        if j1 is None or j2 is None or not a[j1] > -1.0:
            continue
        gid = int(g[j2]) if group else 0
        pred[gid] += np.array([a[j1], b[j1], c[j2]]) @ L
        v[gid] += val[i]
        count[gid] += 1
    cnt = np.maximum(count, 1.0)
    return {"pred": pred, "pmean": pred / cnt[:, None], "v": v / cnt,
            "n": count}


def assert_matches_oracle(got, want, *, group: bool = True):
    """``run()`` against the oracle, row by row through the ``groups``
    column: slot i holds group ``groups[i]`` (PAD_KEY: an empty slot, all
    zeros).  Raw ``g`` is not a slot index: a group absent from the data
    shifts every later group down one slot."""
    if group:
        codes = to_np(got["groups"])
        live = codes != PAD_KEY
        want = {k: np.where(live.reshape((-1,) + (1,) * (w.ndim - 1)),
                            w[np.where(live, codes, 0)], 0.0)
                for k, w in want.items()}
    else:
        want = {k: w[0] for k, w in want.items()}
    for k in STREAM_KEYS:
        np.testing.assert_allclose(to_np(got[k]), want[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
