"""Port parity: the ``Session`` entry point and ``ssb_session`` against
``tests/test_session.py``, case by case, on the same seeded SSB catalog.

Builder ≡ hand-built IR (one structural plan-cache key); registry queries
through the session ≡ the port's direct ``compile_query`` bit for bit, and
≡ the reference's session at the parity rules (exact for tree heads and
integer data, rtol 1e-5 for float sums); multi-aggregate lowering on both
aggregation backends against the reference; ``num_groups="auto"``;
builder validation.  The reference's hypothesis property (builder ≡
hand-built for any draw) becomes fixed draws of a seeded generator; its
mesh case is in ``tests/test_torch_sharding_b.py``, and its traced-compile
case has no counterpart.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fusion import LinearOperator as RefLinear
from repro.core.fusion import random_tree as ref_random_tree
import repro.core.query as RQ
from repro.data import QUERY_IR as REF_QUERY_IR
from repro.data import generate_ssb as ref_generate_ssb
from repro.data import ssb_catalog as ref_ssb_catalog
from repro.data import ssb_session as ref_ssb_session
from repro_torch.core.fusion import LinearOperator
from repro_torch.core.laq import (PAD_GROUP, Catalog, CatalogReadOnlyError,
                                  Pred)
from repro_torch.core.query import (COUNT_STAR, PREDICTION, Aggregate,
                                    ArmSpec, GroupKey, PredictiveQuery,
                                    Session, compile_query, compile_serving,
                                    query, query_key, requests_from_rows)
from repro_torch.data import (PREDICTIVE_QUERIES, QUERIES, QUERY_IR,
                              generate_ssb, ssb_catalog, ssb_session)
from torch_parity import (Both, assert_preds_equal, assert_run_equal,
                          assert_run_like_ref, assert_same, d1_rows, d2_rows,
                          is_tree, port_catalog, port_model, port_query,
                          ref_models, ref_query, ref_star)

ALL_NAMES = sorted(QUERY_IR)


@pytest.fixture(scope="module")
def ref_data():
    return ref_generate_ssb(sf=1, scale=0.0005, seed=5)


@pytest.fixture(scope="module")
def ref_cat(ref_data):
    return ref_ssb_catalog(ref_data)


@pytest.fixture(scope="module")
def data():
    """The port's own SSB data at the reference's seed and size (CPU)."""
    return generate_ssb(sf=1, scale=0.0005, seed=5, device="cpu")


@pytest.fixture(scope="module")
def catalog(ref_cat):
    return port_catalog(ref_cat)


def _linear(k, l, seed=0):
    rng = np.random.default_rng(seed)
    return LinearOperator(torch.from_numpy(
        rng.normal(size=(k, l)).astype(np.float32) / np.sqrt(k)))


# ------------------------------------------------- builder ≡ hand-built IR
def test_builder_lowers_to_handbuilt_ir():
    model = _linear(3, 2)
    built = (query("lineorder")
             .join("date", on=("lo_orderdate", "datekey"),
                   features=["d_month", "d_weeknuminyear"],
                   where=[("d_year", "==", 1993)])
             .join("supplier", on=("lo_suppkey", "suppkey"),
                   features=["s_city"])
             .where(("lo_discount", "between", (1, 3)))
             .predict(model)
             .group_by(("date", "d_year", 8, 1992), num_groups=8)
             .agg(revenue="sum(lo_revenue)", preds=("mean", PREDICTION),
                  n="count")
             .build())
    hand = PredictiveQuery(
        fact="lineorder",
        arms=(ArmSpec("date", "lo_orderdate", "datekey",
                      ("d_month", "d_weeknuminyear"),
                      (Pred("d_year", "==", 1993),)),
              ArmSpec("supplier", "lo_suppkey", "suppkey", ("s_city",))),
        fact_preds=(Pred("lo_discount", "between", (1, 3)),),
        model=model,
        group_keys=(GroupKey("date", "d_year", 8, 1992),),
        aggregates=(Aggregate("lo_revenue", "sum", "revenue"),
                    Aggregate(PREDICTION, "mean", "preds"),
                    Aggregate(COUNT_STAR, "count", "n")),
        num_groups=8)
    for f in dataclasses.fields(PredictiveQuery):
        assert getattr(built, f.name) == getattr(hand, f.name), f.name
    assert query_key(built) == query_key(hand)
    assert built == hand and hash(built) == hash(hand)
    assert built != dataclasses.replace(hand, num_groups=16)


def test_registry_builders_hit_plan_cache(data):
    """Rebuilding a registry query (fresh model tensors each call) gives a
    hash-equal IR that hits the session's plan cache."""
    sess = ssb_session(data)
    assert ssb_session(data) is sess
    for name in ("Q3.2", "P1.linear.year", "P4.tree.select.region"):
        q1, q2 = QUERY_IR[name](), QUERY_IR[name]()
        assert q1 is not q2
        assert query_key(q1) == query_key(q2), name
        assert sess.compile(q1) is sess.compile(q2), name


_ARMS = [
    ("part", "lo_partkey", "partkey", ("p_size", "p_category"),
     (Pred("p_category", "<", 10),)),
    ("supplier", "lo_suppkey", "suppkey", ("s_city",), ()),
    ("date", "lo_orderdate", "datekey", ("d_month",),
     (Pred("d_year", "between", (1993, 1995)),)),
]
_FACT_PREDS = [Pred("lo_discount", "between", (1, 3)),
               Pred("lo_quantity", "<", 25)]
_GKS = [GroupKey("date", "d_year", 8, 1992),
        GroupKey("part", "p_brand1", 1000)]
_AGGS = [("revenue", ("sum", ("mul", "lo_extendedprice", "lo_discount")),
          Aggregate(("mul", "lo_extendedprice", "lo_discount"), "sum",
                    "revenue")),
         ("q_mean", "mean(lo_quantity)",
          Aggregate("lo_quantity", "mean", "q_mean")),
         ("n", "count", Aggregate(COUNT_STAR, "count", "n")),
         ("q_min", "min(lo_quantity)",
          Aggregate("lo_quantity", "min", "q_min")),
         ("preds", ("max", PREDICTION), Aggregate(PREDICTION, "max", "preds"))]


@pytest.mark.parametrize("draw", range(12))
def test_builder_ir_hash_equal_fixed_draws(draw):
    """The reference's property (any builder-made query is hash-equal to
    its hand-built ``PredictiveQuery``), at fixed seeded draws."""
    rng = np.random.default_rng(200 + draw)
    n_arms = int(rng.integers(1, 4))
    fact_preds = bool(rng.integers(0, 2))
    with_model = bool(rng.integers(0, 2))
    n_gks = int(rng.integers(0, 3))
    picks = sorted(set(rng.choice(5, size=int(rng.integers(1, 5)))))
    num_groups = [64, 8192, "auto"][int(rng.integers(0, 3))]
    model = _linear(4, 2)
    aggs = [_AGGS[i] for i in picks if with_model or _AGGS[i][0] != "preds"]
    aggs = aggs or [_AGGS[2]]

    b = query("lineorder")
    for table, fk, pk, feats, preds in _ARMS[:n_arms]:
        b = b.join(table, on=(fk, pk), features=feats, where=preds)
    if fact_preds:
        b = b.where(*_FACT_PREDS)
    if with_model:
        b = b.predict(model)
    if n_gks:
        b = b.group_by(*_GKS[:n_gks], num_groups=num_groups)
    b = b.agg(**{name: spec for name, spec, _ in aggs})
    hand = PredictiveQuery(
        fact="lineorder",
        arms=tuple(ArmSpec(*a) for a in _ARMS[:n_arms]),
        fact_preds=tuple(_FACT_PREDS) if fact_preds else (),
        model=model if with_model else None,
        group_keys=tuple(_GKS[:n_gks]),
        aggregates=tuple(a for _, _, a in aggs),
        num_groups=num_groups if n_gks else 8192)
    built = b.build()
    for f in dataclasses.fields(PredictiveQuery):
        assert getattr(built, f.name) == getattr(hand, f.name), f.name
    assert query_key(built) == query_key(hand)


# ------------------------------------- registry bit-exact through Session
@pytest.fixture(scope="module")
def sessions(ref_data, catalog):
    """The port's session over the reference's catalog, and the
    reference's ``ssb_session``."""
    return Session(catalog), ref_ssb_session(ref_data)


@pytest.mark.parametrize("name", ALL_NAMES)
def test_registry_query_session_bit_exact(name, sessions, catalog):
    """Every registry query through the session equals the direct
    ``compile_query`` path bit for bit, and the reference's session at the
    parity rules."""
    sess, ref_sess = sessions
    got = sess.bind(QUERY_IR[name]()).run()
    assert_same(got, compile_query(catalog, QUERY_IR[name]()).run())
    want = ref_sess.bind(REF_QUERY_IR[name]()).run(rewrite="off")
    assert_run_equal(got, want, exact=is_tree(name))


def test_queries_registry_runs_through_ssb_session(data):
    """``QUERIES``/``PREDICTIVE_QUERIES`` run through the dataset's cached
    session (one plan per query, shared artifacts)."""
    assert sorted(PREDICTIVE_QUERIES) == [n for n in ALL_NAMES
                                          if n.startswith("P")]
    sess = ssb_session(data)
    for name in ("Q1.1", "P3.tree.year"):
        got = QUERIES[name](data)
        assert_same(got, compile_query(ssb_catalog(data),
                                       QUERY_IR[name]()).run())
        assert sess.compile(QUERY_IR[name]()).run().keys() == got.keys()
    assert sess.pool.stats()["entries"] > 0


def test_session_rows_and_serve_match_old_entry_points(sessions, catalog,
                                                       ref_cat):
    sess, ref_sess = sessions
    q = QUERY_IR["P1.linear.year"]()
    ids = np.asarray([0, 1, 5, 17, 100, 2999], np.int32)
    got = sess.bind(q).rows(torch.from_numpy(ids))
    assert_same(got, compile_query(catalog, q).predict_rows(
        torch.from_numpy(ids)))
    assert_preds_equal(got, ref_sess.bind(REF_QUERY_IR["P1.linear.year"]())
                       .rows(ids, rewrite="off"), exact=False)
    runtime = sess.bind(q).serve(buckets=(8, 64))
    old = compile_serving(catalog, q, buckets=(8, 64))
    reqs = requests_from_rows(catalog["lineorder"], q, np.arange(6))
    assert_same(runtime.serve(reqs), old.serve(reqs))
    assert runtime is sess.bind(QUERY_IR["P1.linear.year"]()).serve(
        buckets=(8, 64)), "serving runtimes must be structurally cached"


# --------------------------------------------- multi-aggregate vs reference
_MULTI_AGGS = dict(
    revenue=("sum", ("mul", "lo_extendedprice", "lo_discount")),
    rev_mean=("mean", ("mul", "lo_extendedprice", "lo_discount")),
    n="count",
    q_min="min(lo_quantity)",
    q_max="max(lo_quantity)",
)


@pytest.mark.parametrize("agg_backend", ["segment", "matmul"])
@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "scalar"])
def test_relational_multi_aggregate_matches_reference(agg_backend, grouped,
                                                      sessions):
    """count/mean/min/max over a fact expression, both aggregation
    backends, with and without group keys."""
    got = {}
    for mod, sess in zip(("port", "ref"), sessions):
        b = (sess.query("lineorder")
             .join("date", on=("lo_orderdate", "datekey"))
             .where(("lo_discount", "between", (1, 5)))
             .agg(**_MULTI_AGGS))
        if grouped:
            b = b.group_by(("date", "d_year", 8, 1992), num_groups=8)
        kw = {"rewrite": "off"} if mod == "ref" else {}
        compiled = b.compile(agg_backend=agg_backend, **kw)
        assert compiled.agg_backend == agg_backend or not grouped
        got[mod] = compiled.run()
    assert_run_equal(got["port"], got["ref"], exact=False)


@pytest.mark.parametrize("agg_backend", ["segment", "matmul"])
@pytest.mark.parametrize("backend", ["fused", "nonfused"])
@pytest.mark.parametrize("head", ["linear", "tree"])
def test_prediction_multi_aggregate_matches_reference(agg_backend, backend,
                                                      head, sessions):
    """Two or more named aggregates (mean + count + sum/max of PREDICTION)
    in one compiled program, fused/nonfused × segment/matmul."""
    rng = np.random.default_rng(7)
    ref_model = (RefLinear(jnp.asarray(
        rng.normal(size=(3, 4)).astype(np.float32) / np.sqrt(3)))
        if head == "linear" else ref_random_tree(rng, 3, depth=2))
    got = {}
    for mod, sess in zip(("port", "ref"), sessions):
        model = port_model(ref_model) if mod == "port" else ref_model
        b = (sess.query("lineorder")
             .join("part", on=("lo_partkey", "partkey"),
                   features=["p_size", "p_category"])
             .join("date", on=("lo_orderdate", "datekey"),
                   features=["d_month"],
                   where=[("d_year", "between", (1993, 1996))])
             .predict(model)
             .group_by(("date", "d_year", 8, 1992), num_groups=8)
             .agg(psum=("sum", PREDICTION), pmean=("mean", PREDICTION),
                  n="count", pmax=("max", PREDICTION)))
        kw = {"rewrite": "off"} if mod == "ref" else {}
        compiled = b.compile(backend=backend, agg_backend=agg_backend, **kw)
        assert compiled.backend == backend
        got[mod] = compiled.run()
    res = got["port"]
    assert {"psum", "pmean", "n", "pmax"} <= set(res)
    assert_run_equal(res, got["ref"], exact=head == "tree")
    # mean is exactly the fused sum/count of the same program.
    n = res["n"].numpy()[:, None]
    np.testing.assert_allclose(res["pmean"].numpy(),
                               res["psum"].numpy() / np.maximum(n, 1.0),
                               rtol=1e-6, atol=1e-6)


# ----------------------------------------------------- num_groups="auto"
def test_num_groups_auto_sizes_to_measured_domain(sessions):
    sess, ref_sess = sessions
    base = QUERY_IR["P1.linear.year"]()
    auto = sess.compile(dataclasses.replace(base, num_groups="auto"))
    ref_auto = ref_sess.compile(dataclasses.replace(
        REF_QUERY_IR["P1.linear.year"](), num_groups="auto"), rewrite="off")
    assert isinstance(auto.query.num_groups, int)
    assert auto.query.num_groups == ref_auto.query.num_groups
    live = int((auto.run()["groups"] != PAD_GROUP).sum())
    assert auto.query.num_groups == live
    ref = sess.compile(base).run()
    got = auto.run()
    for k in ("prediction", "groups"):
        assert_same(got[k], ref[k][:auto.query.num_groups])


# ------------------------------------------------ errors and validation
def test_compile_surfaces_bad_aggregate_column(sessions):
    sess, _ = sessions
    b = (sess.query("lineorder")
         .join("date", on=("lo_orderdate", "datekey"))
         .agg(bad="sum(no_such_col)"))
    with pytest.raises(ValueError, match="no_such_col"):
        b.run()


def test_builder_validates_catalog_names(catalog):
    sess = Session(catalog)
    with pytest.raises(KeyError, match="no_such_table"):
        sess.query("no_such_table")
    b = sess.query("lineorder")
    with pytest.raises(KeyError, match="no_such_dim"):
        b.join("no_such_dim", on=("lo_orderdate", "datekey"))
    with pytest.raises(ValueError, match="not a key column"):
        b.join("date", on=("lo_orderdate", "not_a_key"))
    with pytest.raises(ValueError, match="not a key column"):
        b.join("date", on=("lo_revenue", "datekey"))  # float, not a fact key
    with pytest.raises(ValueError, match="feature columns"):
        b.join("date", on=("lo_orderdate", "datekey"), features=["nope"])
    with pytest.raises(ValueError, match="detached"):
        query("lineorder").join(
            "date", on=("lo_orderdate", "datekey")).run()


def test_bound_builder_lowers_like_reference(sessions):
    """A session-bound builder lowers to the same IR as the reference's
    (arm by arm, aggregate by aggregate), and ``bind`` round-trips."""
    sess, ref_sess = sessions
    q = (sess.query("lineorder")
         .join("date", on=("lo_orderdate", "datekey"),
               where=[("d_year", "==", 1993)])
         .agg(a="lo_revenue", b="mean(lo_quantity)", c="count")).build()
    rq = (ref_sess.query("lineorder")
          .join("date", on=("lo_orderdate", "datekey"),
                where=[("d_year", "==", 1993)])
          .agg(a="lo_revenue", b="mean(lo_quantity)", c="count")).build()
    assert port_query(rq) == q
    assert sess.bind(q).build() == q
    assert sess.bind(q).compile() is sess.compile(q)
    assert str(sess.bind(q).explain()) == str(sess.compile(q).explain())


# ------------------------------------- staleness and refresh (Session)
# The cases of tests/test_incremental.py and tests/test_outofcore.py that
# need a Session, on the reference's 2-arm star mutated in step.
def _star_sessions(seed):
    both = Both(ref_star(seed))
    return both, Session(both.port), RQ.Session(both.ref)


def test_session_cache_never_serves_stale_partials():
    both, sess, ref_sess = _star_sessions(21)
    rq = ref_query(ref_models(seed=2)[0], group=False)
    q = port_query(rq)
    builder = sess.bind(q)
    r0 = builder.run()
    rt = builder.serve(buckets=(8,))
    # Keys 55 (odd d1 key) and 10/11 (d2) do not exist yet.
    reqs = {"fk1": np.array([55, 55], np.int32),
            "fk2": np.array([10, 11], np.int32)}
    assert (rt.serve(reqs) == 0).all()
    rng = np.random.default_rng(22)
    new_d1 = d1_rows(rng, 4, start=24)
    new_d1["a"] = np.abs(new_d1["a"])   # pass the d1 arm's a > -1 predicate
    both.append("d1", new_d1)
    both.append("d2", d2_rows(rng, 4, start=10))
    # The same cached objects come back, refreshed: never pre-append state.
    r1 = builder.run()
    assert sess.num_plans == 1
    assert float(r1["n"]) >= float(r0["n"])
    rt2 = builder.serve(buckets=(8,))
    assert rt2 is rt
    assert (rt2.serve(reqs) != 0).any(), \
        "version-keyed cache served pre-append partials"
    cold = Session(both.port).bind(q)
    assert_same(r1, cold.run())
    assert_same(rt2.serve(reqs), cold.serve(buckets=(8,)).serve(reqs))
    ref_builder = ref_sess.bind(rq)
    assert_run_like_ref(r1, ref_builder.run(rewrite="off"), tree=False)
    assert_preds_equal(rt2.serve(reqs),
                       ref_builder.serve(buckets=(8,)).serve(reqs),
                       exact=False)


def test_session_refresh_eager():
    both, sess, ref_sess = _star_sessions(23)
    rq = ref_query(ref_models(seed=4)[0], group=False)
    q = port_query(rq)
    for s, query_ in ((sess, q), (ref_sess, rq)):
        s.bind(query_).run()
        s.bind(query_).serve(buckets=(8,))
    both.append("d1", d1_rows(np.random.default_rng(24), 2, start=24))
    out = sess.refresh()
    assert out == ref_sess.refresh()
    assert len(out) == 2          # one plan + one runtime refreshed
    assert all("delta" in line for line in out.values())
    assert sess.refresh() == {}   # converged


def test_serving_refresh_after_delete_equals_cold():
    both, sess, ref_sess = _star_sessions(13)
    rq = ref_query(ref_models(seed=5)[1], group=False)
    q = port_query(rq)
    rt = sess.serving(q, buckets=(8, 32))
    ref_rt = ref_sess.serving(rq, buckets=(8, 32))
    rng = np.random.default_rng(2)
    batch = {"fk1": rng.integers(0, 48, 20).astype(np.int32),
             "fk2": rng.integers(0, 10, 20).astype(np.int32)}
    rt.serve(batch)
    n0 = rt.num_compiles
    both.delete_rows("d1", [2, 5, 11])
    both.delete_rows("d2", [0, 7])
    assert sess.refresh() == ref_sess.refresh()
    got = rt.serve(batch)
    assert_same(got, compile_serving(both.port, q,
                                     buckets=(8, 32)).serve(batch))
    assert_preds_equal(got, ref_rt.serve(batch), exact=True)
    assert rt.num_compiles == n0


def test_plain_dict_catalogs_wrap_read_only():
    both = Both(ref_star(51))
    plain = dict(both.port.snapshot())
    q = port_query(ref_query(ref_models(seed=10)[0], group=False))
    with pytest.warns(DeprecationWarning, match="plain mapping"):
        cq = compile_query(plain, q)                 # Mapping shim
    sess = Session(plain)                            # Session shim
    assert isinstance(sess.catalog, Catalog) and sess.catalog.read_only
    with pytest.raises(CatalogReadOnlyError):
        sess.catalog.append("d1", d1_rows(np.random.default_rng(0), 1,
                                          start=24))
    assert "no-op" in cq.refresh()
    assert_same(cq.run(), sess.bind(q).run())
