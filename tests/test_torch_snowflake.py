"""Snowflake chains on the port against the JAX reference, case for case
with ``tests/test_snowflake.py``.

The same seeded numpy columns build a reference ``Table`` and a port
``Table`` (on the CPU); each case compiles the chain query in both packages
and holds the port to the reference and to the port's float64 numpy oracle
(``repro_torch.core.query.workload``).  Every column, weight and threshold
is a small integer, so every comparison is **bit-exact**: the port against
the reference, the collapsed chain against the flat ``materialize_chains``
baseline, each chain strategy against the others, a refreshed plan against
a cold compile.  Pool counters and decision lines equal the reference's.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.query as RQ
from repro.core.fusion.operators import LinearOperator as RefLinear
from repro.core.laq import Catalog as RefCatalog
from repro.core.laq import Table as RefTable
from repro.core.query.session import _as_pred as ref_as_pred
from repro.core.query.snowflake import chain_key as ref_chain_key
from repro_torch.core.laq import Catalog, Table
from repro_torch.core.query import (Aggregate, ArmSpec, ArtifactPool,
                                    ChainLink, PredictiveQuery, Session,
                                    compile_query, compile_serving, query,
                                    requests_from_rows)
from repro_torch.core.query.snowflake import (chain_key, chain_tables,
                                              materialize_chains,
                                              participating_tables,
                                              refresh_chain, resolve_chain,
                                              virtual_name)
from repro_torch.core.query.workload import (_compare, np_oracle,
                                             np_serving_oracle)
from torch_parity import assert_same, port_query, to_np

COMBOS = [(b, a) for b in ("fused", "nonfused")
          for a in ("segment", "matmul")]


def _columns(seed=0, n_fact=40):
    """fact → customer → nation → region, integer-valued, with FK misses:
    ``{name: (columns, key_cols, capacity)}`` (``test_snowflake``'s data)."""
    rng = np.random.default_rng(seed)
    region = {"r_pk": np.arange(4), "r_g": rng.integers(0, 3, 4),
              "r_f0": rng.integers(-4, 5, 4)}
    nation = {"n_pk": np.arange(6), "n_to_region": rng.integers(0, 6, 6),
              "n_f0": rng.integers(-4, 5, 6)}
    customer = {"c_pk": np.arange(12),
                "c_to_nation": rng.integers(0, 8, 12),
                "c_f0": rng.integers(-4, 5, 12)}
    fact = {"fk_cust": rng.integers(0, 14, n_fact),
            "s_g": rng.integers(0, 3, n_fact),
            "revenue": rng.integers(-4, 5, n_fact)}
    return {"region": (region, ("r_pk", "r_g"), 8),
            "nation": (nation, ("n_pk", "n_to_region"), 12),
            "customer": (customer, ("c_pk", "c_to_nation"), 20),
            "sales": (fact, ("fk_cust", "s_g"), 64)}


def _both_tables(seed=0):
    """The same columns as reference tables and as port tables (CPU)."""
    ref, port = {}, {}
    for name, (cols, keys, cap) in _columns(seed).items():
        ref[name] = RefTable.from_columns(name, cols, key_cols=keys,
                                          capacity=cap)
        port[name] = Table.from_columns(name, cols, key_cols=keys,
                                        capacity=cap, device="cpu")
    return ref, port


REF_CHAIN_ARM = RQ.ArmSpec(
    "customer", "fk_cust", "c_pk", ("c_f0",), (),
    links=(RQ.ChainLink("nation", "c_to_nation", "n_pk", ("n_f0",)),
           RQ.ChainLink("region", "n_to_region", "r_pk", ("r_f0",),
                        parent="nation")))
CHAIN_ARM = ArmSpec(
    "customer", "fk_cust", "c_pk", ("c_f0",), (),
    links=(ChainLink("nation", "c_to_nation", "n_pk", ("n_f0",)),
           ChainLink("region", "n_to_region", "r_pk", ("r_f0",),
                     parent="nation")))


def _ref_query(model=True, groups=True, preds=False):
    """``test_snowflake._chain_query`` with its predicates normalized."""
    arm = REF_CHAIN_ARM
    fact_preds = ()
    if preds:
        # A sub-dimension predicate two hops deep and a fact-side one.
        links = (dataclasses.replace(arm.links[0],
                                     preds=(ref_as_pred(("n_f0", ">=",
                                                         -2)),)),
                 arm.links[1])
        arm = dataclasses.replace(arm, links=links)
        fact_preds = (ref_as_pred(("revenue", "<=", 3)),)
    m = (RefLinear(jnp.asarray([[1.0], [2.0], [-1.0]], jnp.float32))
         if model else None)
    gks = ((RQ.GroupKey("fact", "s_g", 3), RQ.GroupKey("region", "r_g", 3))
           if groups else ())
    aggs = (RQ.Aggregate("revenue", "sum", "rev"),
            RQ.Aggregate("*", "count", "n"))
    if model:
        aggs += (RQ.Aggregate("@prediction", "sum", "p"),)
    return RQ.PredictiveQuery("sales", (arm,), fact_preds, m, gks, aggs, 9)


def _queries(**kw):
    ref_q = _ref_query(**kw)
    return ref_q, port_query(ref_q)


# --------------------------------------------------------------------------
# prefuse ≡ materialized flat join ≡ float64 oracle ≡ the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("backend,agg_backend", COMBOS)
def test_chain_prefuse_equals_flat_and_oracle(backend, agg_backend):
    ref_t, tables = _both_tables()
    ref_q, q = _queries(preds=True)
    kw = dict(backend=backend, agg_backend=agg_backend)
    res = compile_query(Catalog(dict(tables)), q, **kw).run()
    assert _compare(res, np_oracle(tables, q), q, "port") == []
    assert_same(res, RQ.compile_query(RefCatalog(dict(ref_t)), ref_q,
                                          **kw).run())
    # The flat baseline gathers the sub-dimension group key (region.r_g,
    # two hops deep) through the chain's composed pointers.
    flat_tables, flat_q = materialize_chains(tables, q)
    assert flat_q.group_keys[1].table == virtual_name(q.arms[0])
    flat_cat = Catalog({**{k: v for k, v in tables.items()
                           if k not in chain_tables(q.arms[0])},
                        **flat_tables})
    flat = compile_query(flat_cat, flat_q, **kw).run()
    assert_same(res, flat)
    ref_flat_t, _ = RQ.materialize_chains(ref_t, ref_q)
    for name, t in flat_tables.items():
        np.testing.assert_array_equal(to_np(t.matrix),
                                      np.asarray(ref_flat_t[name].matrix))
        for c in t.keys:
            np.testing.assert_array_equal(
                to_np(t.key(c)), np.asarray(ref_flat_t[name].key(c)))


@pytest.mark.parametrize("strategy", ["through", "materialize", "auto"])
def test_chain_strategy_bit_equal_and_explained(strategy):
    ref_t, tables = _both_tables()
    ref_q, q = _queries(preds=True)
    plan = compile_query(Catalog(dict(tables)), q, chain_strategy=strategy)
    ref = RQ.compile_query(RefCatalog(dict(ref_t)), ref_q,
                           chain_strategy=strategy)
    assert "chain[" in plan.plan.reason
    assert virtual_name(q.arms[0]) in plan.plan.reason
    chain_note = [r for r in plan.plan.reason.split("; ")
                  if r.startswith("chain[")]
    assert chain_note == [r for r in ref.plan.reason.split("; ")
                          if r.startswith("chain[")]
    assert plan._chains[0].cached_hops == ref._chains[0].cached_hops
    assert _compare(plan.run(), np_oracle(tables, q), q, strategy) == []
    assert_same(plan.run(), ref.run())


def test_chain_without_model_or_groups():
    ref_t, tables = _both_tables(seed=3)
    for model, groups in ((False, True), (True, False), (False, False)):
        ref_q, q = _queries(model=model, groups=groups)
        res = compile_query(Catalog(dict(tables)), q).run()
        assert _compare(res, np_oracle(tables, q), q,
                        f"m={model} g={groups}") == []
        assert_same(res, RQ.compile_query(RefCatalog(dict(ref_t)),
                                              ref_q).run())


# --------------------------------------------------------------------------
# Refresh: sub-dimension appends through the chain == cold compile
# --------------------------------------------------------------------------
def test_refresh_after_subdim_append_equals_cold():
    ref_t, tables = _both_tables(seed=1)
    ref_q, q = _queries()
    cat, ref_cat = Catalog(dict(tables)), RefCatalog(dict(ref_t))
    sess, ref_sess = Session(cat), RQ.Session(ref_cat)
    sess.compile(q).run()
    ref_sess.compile(ref_q).run()
    rng = np.random.default_rng(11)
    # Every chain hop and the fact, one at a time; the cached plan against
    # a cold compile (and the reference's session) after each.
    appends = [
        ("nation", {"n_pk": [6, 7], "n_to_region": [1, 9],
                    "n_f0": [2, -3]}),
        ("region", {"r_pk": [4], "r_g": [1], "r_f0": [0]}),
        ("customer", {"c_pk": [12, 13], "c_to_nation": [7, 2],
                      "c_f0": [1, 4]}),
        ("sales", {"fk_cust": rng.integers(0, 14, 3), "s_g": [0, 2, 1],
                   "revenue": [3, -1, 0]}),
    ]
    for name, rows in appends:
        rows = {k: np.asarray(v) for k, v in rows.items()}
        cat.append(name, rows)
        ref_cat.append(name, rows)
        plan = sess.compile(q)
        line = plan._refresh_notes[-1]
        assert line == ref_sess.compile(ref_q)._refresh_notes[-1]
        assert line.startswith(f"refresh=delta({name}+1;"), line
        res = plan.run()
        snap = {n: cat[n] for n in cat}
        assert _compare(res, np_oracle(snap, q), q, f"refresh[{name}]") == []
        cold = compile_query(Catalog(snap), q)
        assert_same(res, cold.run())
        assert_same(res, ref_sess.compile(ref_q).run())
        for a, b in zip(plan.prefused.partials, cold.prefused.partials):
            np.testing.assert_array_equal(to_np(a), to_np(b))


def test_resolve_chain_refresh_matches_cold_collapse():
    ref_t, tables = _both_tables(seed=2)
    cat, ref_cat = Catalog(dict(tables)), RefCatalog(dict(ref_t))
    arm = CHAIN_ARM
    cc = resolve_chain(cat, arm, keep_hops=len(arm.links))
    assert cc.cached_hops == 2
    rows = {"n_pk": np.array([6]), "n_to_region": np.array([2]),
            "n_f0": np.array([-1])}
    cat.append("nation", rows)
    ref_cat.append("nation", rows)
    warm = refresh_chain(cat, cc, {"nation"})
    cold = resolve_chain(cat, arm)
    ref = RQ.resolve_chain(ref_cat, REF_CHAIN_ARM)
    for got in (warm, cold):
        np.testing.assert_array_equal(to_np(got.dmask), to_np(cold.dmask))
        np.testing.assert_array_equal(to_np(got.table.matrix),
                                      np.asarray(ref.table.matrix))
        np.testing.assert_array_equal(to_np(got.dmask),
                                      np.asarray(ref.dmask))
        for (n, p, f), (rn, rp, rf) in zip(got.link_ptrs, ref.link_ptrs):
            assert n == rn
            np.testing.assert_array_equal(to_np(p), np.asarray(rp))
            np.testing.assert_array_equal(to_np(f), np.asarray(rf))


# --------------------------------------------------------------------------
# IR validation
# --------------------------------------------------------------------------
def test_duplicate_alias_rejected():
    arm = CHAIN_ARM
    with pytest.raises(ValueError, match="duplicate table alias"):
        PredictiveQuery("sales", (arm, arm))
    dup_link = dataclasses.replace(
        arm, links=arm.links + (ChainLink("nation", "x", "n_pk"),))
    with pytest.raises(ValueError, match="duplicate table alias 'nation'"):
        PredictiveQuery("sales", (dup_link,))


def test_non_parent_first_chain_rejected():
    bad = dataclasses.replace(
        CHAIN_ARM,
        links=(ChainLink("region", "n_to_region", "r_pk", parent="nation"),
               ChainLink("nation", "c_to_nation", "n_pk")))
    with pytest.raises(ValueError, match="declared parent-first"):
        PredictiveQuery("sales", (bad,))
    selfref = dataclasses.replace(
        CHAIN_ARM,
        links=(ChainLink("nation", "c_to_nation", "n_pk", parent="region"),))
    with pytest.raises(ValueError, match="parent 'region'"):
        PredictiveQuery("sales", (selfref,))


def test_chain_key_ignores_fk_and_names_hops():
    a1 = CHAIN_ARM
    a2 = dataclasses.replace(a1, fk_col="other_fk")
    assert chain_key(a1) == chain_key(a2)  # the FK is the fact's business
    a3 = dataclasses.replace(a1, links=a1.links[:1])
    assert chain_key(a1) != chain_key(a3)
    assert virtual_name(a1) == "customer->nation->region"
    assert set(participating_tables(PredictiveQuery("sales", (a1,)))) == {
        "sales", "customer", "nation", "region"}
    # Content equality of the IR sees the links.
    assert PredictiveQuery("sales", (a1,)) != PredictiveQuery("sales", (a3,))
    assert PredictiveQuery("sales", (a1,)) == PredictiveQuery(
        "sales", (dataclasses.replace(a1),))


# --------------------------------------------------------------------------
# Builder surface: via=, chained joins, link parsing
# --------------------------------------------------------------------------
def _bound_session():
    return Session(Catalog(dict(_both_tables()[1])))


def test_builder_via_equals_explicit_ir():
    sess = _bound_session()
    q = (sess.query("sales")
         .join("customer", on=("fk_cust", "c_pk"), features=["c_f0"],
               via=[("nation", "c_to_nation", "n_pk", ["n_f0"]),
                    {"table": "region", "fk_col": "n_to_region",
                     "pk_col": "r_pk", "features": ["r_f0"],
                     "parent": "nation"}])
         .build())
    assert q.arms == _queries(model=False, groups=False)[1].arms


def test_builder_chained_join_auto_attaches():
    ref_t, tables = _both_tables()
    sess = Session(Catalog(dict(tables)))
    q = (sess.query("sales")
         .join("customer", on=("fk_cust", "c_pk"), features=["c_f0"])
         .join("nation", on=("c_to_nation", "n_pk"), features=["n_f0"])
         .join("region", on=("n_to_region", "r_pk"), features=["r_f0"])
         .build())
    ref_sess = RQ.Session(RefCatalog(dict(ref_t)))
    ref_q = (ref_sess.query("sales")
             .join("customer", on=("fk_cust", "c_pk"), features=["c_f0"])
             .join("nation", on=("c_to_nation", "n_pk"), features=["n_f0"])
             .join("region", on=("n_to_region", "r_pk"), features=["r_f0"])
             .build())
    assert len(q.arms) == 1
    assert [lk.table for lk in q.arms[0].links] == ["nation", "region"]
    assert q.arms == port_query(ref_q).arms
    qa = dataclasses.replace(
        q, aggregates=(Aggregate("revenue", "sum", "rev"),), num_groups=1)
    res = compile_query(sess.catalog, qa).run()
    assert _compare(res, np_oracle(tables, qa), qa, "auto-chain") == []
    ref_res = RQ.compile_query(ref_sess.catalog, dataclasses.replace(
        ref_q, aggregates=(RQ.Aggregate("revenue", "sum", "rev"),),
        num_groups=1)).run()
    assert_same(res, ref_res)


def test_builder_bad_links_are_named_errors():
    sess = _bound_session()
    b = sess.query("sales").join("customer", on=("fk_cust", "c_pk"))
    with pytest.raises(ValueError, match="unknown keys"):
        b.join("nation", on=("c_to_nation", "n_pk"),
               via=[{"table": "nation", "fk_col": "c_to_nation",
                     "pk_col": "n_pk", "banana": 1}])
    with pytest.raises(ValueError, match="unparseable chain link"):
        b.join("nation", on=("c_to_nation", "n_pk"), via=[("nation",)])
    with pytest.raises(ValueError, match="missing key"):
        b.join("nation", on=("c_to_nation", "n_pk"),
               via=[{"table": "nation", "fk_col": "c_to_nation"}])
    with pytest.raises(ValueError, match="not a key column of parent"):
        sess.query("sales").join("customer", on=("fk_cust", "c_pk"),
                                 via=[("nation", "no_such_fk", "n_pk")])


def test_builder_detached_never_auto_chains():
    q = (query("sales")
         .join("customer", on=("fk_cust", "c_pk"))
         .join("nation", on=("c_to_nation", "n_pk"))
         .build())
    # Detached builders have no catalog to inspect: both joins stay arms.
    assert len(q.arms) == 2 and not q.arms[0].links


# --------------------------------------------------------------------------
# Pooled chains (multi-query sharing)
# --------------------------------------------------------------------------
def test_pooled_chain_shared_and_refreshed_once():
    ref_t, tables = _both_tables(seed=4)
    cat, ref_cat = Catalog(dict(tables)), RefCatalog(dict(ref_t))
    pool, ref_pool = ArtifactPool(cat), RQ.ArtifactPool(ref_cat)
    ref_q1 = _ref_query()
    ref_q2 = dataclasses.replace(
        ref_q1, aggregates=(RQ.Aggregate("revenue", "max", "mx"),))
    q1, q2 = port_query(ref_q1), port_query(ref_q2)
    p1, p2 = (compile_query(cat, q, pool=pool) for q in (q1, q2))
    r1, r2 = (RQ.compile_query(ref_cat, q, pool=ref_pool)
              for q in (ref_q1, ref_q2))
    st = pool.stats()
    assert st["by_kind"].get("chain") == 1      # one collapsed chain shared
    ck = chain_key(q1.arms[0])
    assert pool.refcount(ck) >= 2
    for k in ("entries", "hits", "misses", "by_kind"):
        assert st[k] == ref_pool.stats()[k], k

    rows = {"r_pk": np.array([4, 5]), "r_g": np.array([2, 0]),
            "r_f0": np.array([3, -4])}
    cat.append("region", rows)
    ref_cat.append("region", rows)
    lines = [p.refresh() for p in (p1, p2)]
    assert lines == [r.refresh() for r in (r1, r2)]
    res1, res2 = p1.run(), p2.run()
    assert pool.update_count(ck) == 1           # refreshed exactly once
    snap = {n: cat[n] for n in cat}
    assert _compare(res1, np_oracle(snap, q1), q1, "pooled-q1") == []
    assert _compare(res2, np_oracle(snap, q2), q2, "pooled-q2") == []
    assert_same(res1, r1.run())
    assert_same(res2, r2.run())
    assert_same(res1, compile_query(Catalog(snap), q1).run())
    assert pool.stats()["updates"] == ref_pool.stats()["updates"]

    p1.close()
    p2.close()
    assert pool.stats()["entries"] == 0


# --------------------------------------------------------------------------
# Serving chains
# --------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["fused", "nonfused"])
def test_serving_chain_matches_oracle(backend):
    ref_t, tables = _both_tables(seed=5)
    ref_q, q = _queries(groups=False)
    rt = compile_serving(Catalog(dict(tables)), q, backend=backend)
    ref_rt = RQ.compile_serving(RefCatalog(dict(ref_t)), ref_q,
                                backend=backend)
    n = int(tables["sales"].nvalid)
    reqs = requests_from_rows(tables["sales"], q, np.arange(n))
    got = to_np(rt.serve(reqs))
    np.testing.assert_array_equal(got.astype(np.float64),
                                  np_serving_oracle(tables, q))
    np.testing.assert_array_equal(got, np.asarray(ref_rt.serve(reqs)))


def test_serving_chain_append_rebuilds_and_matches_cold():
    ref_t, tables = _both_tables(seed=6)
    ref_q, q = _queries(groups=False)
    cat, ref_cat = Catalog(dict(tables)), RefCatalog(dict(ref_t))
    rt, ref_rt = compile_serving(cat, q), RQ.compile_serving(ref_cat, ref_q)
    rows = {"n_pk": np.array([6]), "n_to_region": np.array([0]),
            "n_f0": np.array([4])}
    cat.append("nation", rows)
    ref_cat.append("nation", rows)
    note = rt.refresh()
    assert "chain tables changed" in note and "nation" in note
    assert note == ref_rt.refresh()
    snap = {n: cat[n] for n in cat}
    reqs = requests_from_rows(snap["sales"], q,
                              np.arange(int(snap["sales"].nvalid)))
    warm = to_np(rt.serve(reqs))
    cold = to_np(compile_serving(Catalog(snap), q).serve(reqs))
    np.testing.assert_array_equal(warm, cold)
    np.testing.assert_array_equal(warm.astype(np.float64),
                                  np_serving_oracle(snap, q))
    np.testing.assert_array_equal(warm, np.asarray(ref_rt.serve(reqs)))


# --------------------------------------------------------------------------
# Stacked classes and pooled serving over chains (through a Session)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("backend,model", [("fused", "linear"),
                                           ("nonfused", "tree")])
def test_run_all_stacks_chained_class(backend, model):
    """Three members of one class (one chain, fact spans differing), on
    the kernel path (``join_backend="gather"``, ``serve_backend="kernel"``;
    the plain versions on the CPU): ``run_all`` equals each member's
    ``run()`` and the reference's ``run_all``, bit for bit."""
    from repro.core.fusion.operators import tree_from_arrays as ref_tree
    ref_t, tables = _both_tables(seed=7)
    base = _ref_query(preds=True)
    if model == "tree":
        tree = ref_tree(np.array([0, 1, 2]),
                        np.array([0., 1., -1.], np.float32), 3)
        base = dataclasses.replace(base, model=tree)
    ref_qs = [dataclasses.replace(base, fact_preds=(
        ref_as_pred(("revenue", ">=", lo)),)) for lo in (-4, -1, 2)]
    qs = [port_query(r) for r in ref_qs]
    sess, ref_sess = (Session(Catalog(dict(tables))),
                      RQ.Session(RefCatalog(dict(ref_t))))
    kw = dict(backend=backend, join_backend="gather", serve_backend="kernel")
    outs = sess.run_all(qs, **kw)
    ref_outs = ref_sess.run_all(ref_qs, backend=backend,
                                join_backend="gather")
    plans = [sess.compile(q, **kw) for q in qs]
    from repro_torch.core.query import stack_key
    assert len({stack_key(p) for p in plans}) == 1
    for out, ref_out, p, q in zip(outs, ref_outs, plans, qs):
        assert_same(out, p.run())
        assert_same(out, ref_out)
        assert _compare(out, np_oracle(tables, q), q, "run_all") == []


def test_session_serving_chain_pooled_refresh():
    ref_t, tables = _both_tables(seed=8)
    ref_q, q = _queries(groups=False)
    cat, ref_cat = Catalog(dict(tables)), RefCatalog(dict(ref_t))
    sess, ref_sess = Session(cat), RQ.Session(ref_cat)
    rt, ref_rt = sess.serving(q), ref_sess.serving(ref_q)
    plan = sess.compile(q)
    ck = chain_key(q.arms[0])
    assert ck in sess.pool and ck in rt._pool_keys()
    rows = {"region": {"r_pk": np.array([4]), "r_g": np.array([1]),
                       "r_f0": np.array([3])},
            "customer": {"c_pk": np.array([12]),
                         "c_to_nation": np.array([1]),
                         "c_f0": np.array([-2])}}
    for name, r in rows.items():
        cat.append(name, r)
        ref_cat.append(name, r)
        rt2, ref_rt2 = sess.serving(q), ref_sess.serving(ref_q)
        assert rt2 is rt
        assert rt._refresh_notes[-1] == ref_rt2._refresh_notes[-1]
        assert "re-collapsed" in rt._refresh_notes[-1]
        snap = {n: cat[n] for n in cat}
        reqs = requests_from_rows(snap["sales"], q,
                                  np.arange(int(snap["sales"].nvalid)))
        warm = to_np(rt.serve(reqs))
        np.testing.assert_array_equal(
            warm, to_np(compile_serving(Catalog(snap), q).serve(reqs)))
        np.testing.assert_array_equal(warm, np.asarray(ref_rt.serve(reqs)))
        res = sess.compile(q).run()
        assert_same(res, compile_query(Catalog(snap), q).run())
        assert (sess.pool.update_count(ck)
                == ref_sess.pool.update_count(ref_chain_key(ref_q.arms[0])))
    plan.close()
    rt.close()


# --------------------------------------------------------------------------
# Planner and dirty-head helpers against the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("parent_rows", [(12, 12), (900_000, 10),
                                         (10, 900_000), (), (838_861,)])
@pytest.mark.parametrize("strategy", ["auto", "through", "materialize"])
def test_plan_chain_materialization_matches_reference(parent_rows, strategy):
    from repro.core.query.planner import \
        plan_chain_materialization as ref_plan
    from repro_torch.core.query import plan_chain_materialization
    got = plan_chain_materialization("a->b->c", list(parent_rows),
                                     strategy=strategy, platform="cpu")
    assert got == ref_plan("a->b->c", list(parent_rows), strategy=strategy,
                           platform="cpu")
    # The budget is the CPU-seeded default row on the card too.
    assert plan_chain_materialization("a->b->c", list(parent_rows),
                                      strategy=strategy,
                                      platform="cuda") == got


def test_chain_dirty_heads_match_reference():
    from repro.core.query.snowflake import \
        chain_dirty_heads as ref_dirty_heads
    from repro_torch.core.query.snowflake import chain_dirty_heads
    ref_t, tables = _both_tables(seed=9)
    cc = resolve_chain(tables, CHAIN_ARM)
    ref_cc = RQ.resolve_chain(ref_t, REF_CHAIN_ARM)
    for touched in ({"nation": [0, 3]}, {"region": [1]},
                    {"customer": [2, 5], "region": [0, 2, 3]},
                    {"nation": []}, {}):
        got = chain_dirty_heads(cc, {k: np.asarray(v, np.int64)
                                     for k, v in touched.items()})
        want = ref_dirty_heads(ref_cc, {k: np.asarray(v, np.int64)
                                        for k, v in touched.items()})
        if want is None:
            assert got is None
        else:
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(to_np(got), want)
