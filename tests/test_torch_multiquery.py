"""Port parity: the multi-query optimizer (``ArtifactPool``, pooled
compilation and serving, ``Session.run_all``, stacked classes) against
``tests/test_multiquery.py``, case by case, on the same seeded SSB catalog.

Held exactly: pool statistics (entries, hits, misses, evictions, updates,
bytes, kinds) after the same sequence of compiles and refreshes as the
reference's pool, every refresh decision line, backend decisions, and each
pooled or stacked result against the port's own unpooled ``run()``.  Against
the reference's results: exact for tree heads and integer data, rtol 1e-5
for float sums (another framework's summation order).  The reference runs
with ``rewrite="off"``, the plan the port compiles.

The reference's property test over random registry subsets becomes fixed
draws of a seeded generator; its traced-compile case has no counterpart
(PyTorch runs eagerly: a pooled compile never sees a tracer).
"""
import dataclasses
import sys
import warnings

import numpy as np
import pytest

import repro.core.query as RQ
from repro.core.laq import Catalog as RefCatalog
from repro.core.laq.selection import Pred as RefPred
from repro.data import QUERY_IR as REF_QUERY_IR
from repro.data import generate_ssb as ref_generate_ssb
from repro.data import ssb_catalog as ref_ssb_catalog
from repro_torch.core.laq import Pred
from repro_torch.core.query import (ArtifactPool, ExplainReport, Session,
                                    artifact_bytes, compile_query,
                                    compile_serving, make_stacked_runner,
                                    stack_key, stack_states)
from repro_torch.data import QUERY_IR, predictive_query_names
from torch_parity import (Both, assert_preds_equal, assert_run_equal,
                          assert_same, is_tree, port_catalog)

ALL_NAMES = sorted(QUERY_IR)


@pytest.fixture(scope="module")
def ref_data():
    return ref_generate_ssb(sf=1, scale=0.0005, seed=5)


@pytest.fixture(scope="module")
def ref_cat(ref_data):
    return ref_ssb_catalog(ref_data)


@pytest.fixture(scope="module")
def catalog(ref_cat):
    """The port's copy of the reference's SSB catalog (read-only, CPU)."""
    return port_catalog(ref_cat)


@pytest.fixture(scope="module")
def ref_runs(ref_cat):
    """The reference's ``run()`` of every registry query."""
    return {n: RQ.compile_query(ref_cat, REF_QUERY_IR[n](),
                                rewrite="off").run() for n in ALL_NAMES}


def _fresh(ref_data):
    """Writable catalogs in step (the reference's ``_fresh_session``) and a
    session over each."""
    ro = ref_ssb_catalog(ref_data)
    both = Both(RefCatalog({n: ro[n] for n in ro}))
    return both, Session(both.port), RQ.Session(both.ref)


def _keys(keys) -> set:
    """Pool keys of either package, comparable: a key holds predicates
    (each package's own ``Pred``, equal in repr) and content digests."""
    return {repr(k) for k in keys}


def _append_dim_rows(both, table, frac=0.01):
    """The reference's ``_append_dim_rows``, applied to both catalogs."""
    t = both.ref[table]
    n = max(1, int(t.nvalid * frac))
    cols = {}
    for cname in t.columns:
        col = np.asarray(t.col(cname)[:n])
        if cname in t.keys:
            col = np.arange(t.nvalid, t.nvalid + n, dtype=col.dtype)
        cols[cname] = col
    both.append(table, cols)
    return n


# ---------------------------------------------------------------------------
# Pooled ≡ independent, bit for bit; pool stats ≡ the reference's
# ---------------------------------------------------------------------------
def test_pooled_registry_bit_exact(catalog, ref_cat, ref_runs):
    """Every registry query: pooled plan ≡ standalone plan bit for bit,
    same backends; the pool's counters equal the reference pool's."""
    pool, ref_pool = ArtifactPool(catalog), RQ.ArtifactPool(ref_cat)
    for name in ALL_NAMES:
        pooled = compile_query(catalog, QUERY_IR[name](), pool=pool)
        solo = compile_query(catalog, QUERY_IR[name]())
        ref = RQ.compile_query(ref_cat, REF_QUERY_IR[name](), pool=ref_pool,
                               rewrite="off")
        assert ((pooled.backend, pooled.join_backend, pooled.agg_backend)
                == (solo.backend, solo.join_backend, solo.agg_backend)
                == (ref.backend, ref.join_backend, ref.agg_backend)), name
        assert_same(pooled.run(), solo.run())
        assert_run_equal(pooled.run(), ref_runs[name], exact=is_tree(name))
        assert _keys(pooled._pool_keys()) == _keys(ref._pool_keys()), name
    st = pool.stats()
    assert st["hits"] > 0, "registry shares no artifacts?!"
    assert st["entries"] == st["misses"]
    assert st == ref_pool.stats()


def test_pooled_sharing_reduces_artifacts(catalog, ref_cat):
    """N plans over the same arms hold ONE physical index/join/partial:
    resident derived bytes under the pool are well below independent, and
    equal to the reference's count."""
    pool, ref_pool = ArtifactPool(catalog), RQ.ArtifactPool(ref_cat)
    pooled = [compile_query(catalog, QUERY_IR[n](), pool=pool)
              for n in ALL_NAMES]
    solo = [compile_query(catalog, QUERY_IR[n]()) for n in ALL_NAMES]
    ref_pooled = [RQ.compile_query(ref_cat, REF_QUERY_IR[n](),
                                   pool=ref_pool, rewrite="off")
                  for n in ALL_NAMES]
    shared, indep = artifact_bytes(pooled), artifact_bytes(solo)
    assert shared < indep / 2, (shared, indep)
    assert shared == RQ.artifact_bytes(ref_pooled)
    # Q2.1/2.2/2.3 share the part arm's join columns.
    k2 = [p for n, p in zip(ALL_NAMES, pooled) if n.startswith("Q2.")]
    ptrs = {id(fj.ptr) for p in k2 for fj in p.star.joins}
    assert len(ptrs) < sum(len(p.star.joins) for p in k2)


def test_pooled_serving_bit_exact(catalog, ref_cat):
    pool, ref_pool = ArtifactPool(catalog), RQ.ArtifactPool(ref_cat)
    rng = np.random.default_rng(3)
    for name in predictive_query_names():
        pooled = compile_serving(catalog, QUERY_IR[name](), buckets=(4, 16),
                                 pool=pool)
        solo = compile_serving(catalog, QUERY_IR[name](), buckets=(4, 16))
        ref = RQ.compile_serving(ref_cat, REF_QUERY_IR[name](),
                                 buckets=(4, 16), pool=ref_pool)
        reqs = {a.fk_col: rng.integers(
            0, catalog[a.table].nvalid + 2, size=9).astype(np.int32)
            for a in QUERY_IR[name]().arms}
        assert_same(pooled.serve(reqs), solo.serve(reqs))
        assert_preds_equal(pooled.serve(reqs), ref.serve(reqs),
                           exact=is_tree(name))
    assert pool.stats()["hits"] > 0
    assert pool.stats() == ref_pool.stats()


@pytest.mark.parametrize("draw", range(4))
def test_pooled_random_subsets_fixed_draws(catalog, draw):
    """The reference's property (any 5-query subset, in any order, through
    one pool ≡ independent compilation), at fixed seeded draws."""
    names = list(np.random.default_rng(100 + draw).permutation(ALL_NAMES)[:5])
    pool = ArtifactPool(catalog)
    for name in names:
        plan = compile_query(catalog, QUERY_IR[name](), pool=pool)
        assert_same(plan.run(), compile_query(catalog,
                                              QUERY_IR[name]()).run())
        plan.close()
    assert pool.stats()["entries"] == 0   # all references released


# ---------------------------------------------------------------------------
# Refcounts: eviction only on last release
# ---------------------------------------------------------------------------
def test_refcount_evicts_on_last_release(catalog):
    pool = ArtifactPool(catalog)
    a = compile_query(catalog, QUERY_IR["Q2.1"](), pool=pool)
    b = compile_query(catalog, QUERY_IR["Q2.1"](), pool=pool)
    keys = set(a._pool_keys())
    assert keys and keys == set(b._pool_keys())
    n0 = pool.stats()["entries"]
    a.close()
    assert pool.stats()["entries"] == n0          # b still holds every key
    assert all(pool.refcount(k) >= 1 for k in keys)
    b.close()
    assert all(pool.refcount(k) == 0 for k in keys)
    assert pool.stats()["entries"] < n0           # last release evicts
    a.close()                                      # idempotent
    assert pool.stats()["evictions"] >= len(keys)


def test_session_evict_drains_pool(ref_data):
    _, sess, _ = _fresh(ref_data)
    for n in ALL_NAMES[:6]:
        sess.compile(QUERY_IR[n]())
    assert sess.pool.stats()["entries"] > 0
    assert sess.evict() == 6 and sess.num_plans == 0
    assert sess.pool.stats()["entries"] == 0
    assert sess.pool.stats()["bytes"] == 0


def test_session_evict_single_query(ref_data):
    _, sess, _ = _fresh(ref_data)
    q1, q2 = QUERY_IR["Q1.1"](), QUERY_IR["Q1.2"]()
    sess.compile(q1)
    sess.compile(q2)
    assert sess.evict(q1) == 1
    assert sess.num_plans == 1
    assert sess.pool.stats()["entries"] > 0       # q2's artifacts survive
    assert_same(sess.compile(q2).run(),
                compile_query(sess.catalog, q2).run())


# ---------------------------------------------------------------------------
# Refresh: one update per distinct shared artifact
# ---------------------------------------------------------------------------
def test_refresh_updates_shared_artifact_once(ref_data):
    """Three plans sharing the part arm + a 1% append: each shared entry
    refreshes exactly once, the decision lines and pool counters are the
    reference's, and every plan equals a cold compile bit for bit."""
    both, sess, ref_sess = _fresh(ref_data)
    # The first append doubles part's capacity, so the one measured below
    # lands inside the padding (delta path, no recompile).
    _append_dim_rows(both, "part")
    names = ["Q2.1", "Q2.2", "Q2.3"]
    plans = [sess.compile(QUERY_IR[n]()) for n in names]
    for n in names:
        ref_sess.compile(REF_QUERY_IR[n](), rewrite="off")
    shared = [k for k in plans[0]._pool_keys()
              if k[0] in ("pkindex", "join") and "part" in k]
    assert shared
    before = {k: sess.pool.update_count(k) for k in shared}
    _append_dim_rows(both, "part")
    out = sess.refresh()
    assert out == ref_sess.refresh()
    assert set(out.values()) == {
        "refresh=delta(part+1; pooled artifacts, jit cache reused)"}
    for k in shared:
        assert sess.pool.update_count(k) - before[k] == 1, k
    assert sess.pool.stats() == ref_sess.pool.stats()
    for n, p in zip(names, plans):
        cold = compile_query(sess.catalog, QUERY_IR[n]())
        assert_same(p.run(), cold.run())
        assert_run_equal(p.run(), ref_sess.compile(
            REF_QUERY_IR[n](), rewrite="off").run(), exact=False)


def test_refresh_pooled_serving_and_growth(ref_data):
    """Pooled runtimes and fused/nonfused plans over part: a delta append,
    then one past part's capacity.  Lines and pool counters are the
    reference's; each object equals a cold build bit for bit."""
    both, sess, ref_sess = _fresh(ref_data)
    _append_dim_rows(both, "part")
    names = ("P1.linear.year", "P3.tree.year")
    for n in names:
        sess.compile(QUERY_IR[n]())
        ref_sess.compile(REF_QUERY_IR[n](), rewrite="off")
        for b in ("fused", "nonfused"):
            sess.serving(QUERY_IR[n](), buckets=(4, 16), backend=b)
            ref_sess.serving(REF_QUERY_IR[n](), buckets=(4, 16), backend=b)
    rng = np.random.default_rng(4)
    for frac, line in ((0.01, "delta"), (1.0, "growth")):
        _append_dim_rows(both, "part", frac)
        out = sess.refresh()
        assert out == ref_sess.refresh(), line
        assert sess.pool.stats() == ref_sess.pool.stats(), line
        for n in names:
            q = QUERY_IR[n]()
            assert_same(sess.compile(q).run(),
                        compile_query(sess.catalog, q).run())
            reqs = {a.fk_col: rng.integers(
                0, sess.catalog[a.table].nvalid + 2, size=9).astype(np.int32)
                for a in q.arms}
            for b in ("fused", "nonfused"):
                rt = sess.serving(q, buckets=(4, 16), backend=b)
                cold = compile_serving(sess.catalog, q, buckets=(4, 16),
                                       backend=b)
                assert_same(rt.serve(reqs), cold.serve(reqs))
                for a, c in zip(rt._arms, cold._arms):
                    assert_same(a.table, c.table)
                    assert_same(a.dmask, c.dmask)


@pytest.mark.parametrize("pooled", [True, False], ids=["pooled", "unpooled"])
def test_refresh_fused_kernel_plan_join_stack(ref_data, pooled):
    """A fused plan on the kernel serve backend reads its joins as one
    ``(J, n)`` stack: an unpooled plan's columns are row views of it, a
    pooled plan's are the pool's.  A refresh that moves no pointer (a
    deletion) keeps the stack; an append that does stacks anew and leaves the old stack
    whole.  The refreshed plan equals a cold compile bit for bit."""
    both, sess, _ = _fresh(ref_data)
    _append_dim_rows(both, "part")     # capacity for the deltas below
    q = QUERY_IR["P1.linear.year"]()
    kw = dict(backend="fused", serve_backend="kernel")
    plan = (sess.compile(q, **kw) if pooled
            else compile_query(both.port, q, **kw))
    ptrs, founds = plan._state["stacked_joins"]
    views = all(p.data_ptr() == ptrs[j].data_ptr()
                for j, p in enumerate(plan._state["ptrs"]))
    assert views != pooled
    both.delete_rows("part", [0, 1])   # a validity fold: no pointer moves
    assert "delta" in plan.refresh()
    assert plan._state["stacked_joins"][0] is ptrs       # nothing moved
    kept = ptrs.clone()
    _append_dim_rows(both, "part")
    assert "delta" in plan.refresh()
    new_ptrs, new_founds = plan._state["stacked_joins"]
    assert new_ptrs is not ptrs
    assert_same(ptrs, kept)                               # old stack whole
    cold = compile_query(both.port, q, **kw)
    assert_same(new_ptrs, cold._state["stacked_joins"][0])
    assert_same(new_founds, cold._state["stacked_joins"][1])
    assert_same(plan.run(), cold.run())
    assert_same(plan.predictions(), cold.predictions())


def test_refresh_noop_leaves_update_counts(ref_data):
    _, sess, _ = _fresh(ref_data)
    p = sess.compile(QUERY_IR["Q1.1"]())
    keys = p._pool_keys()
    before = [sess.pool.update_count(k) for k in keys]
    assert sess.refresh() == {}       # no catalog change
    assert [sess.pool.update_count(k) for k in keys] == before


def test_refreshed_entry_is_a_new_tensor(ref_data):
    """Value semantics: a refreshed pool entry is a new tensor and the old
    one keeps its values, so a plan holding the old state stays whole."""
    both, sess, _ = _fresh(ref_data)
    _append_dim_rows(both, "part")
    p = sess.compile(QUERY_IR["P1.linear.year"]())
    old = {k: sess.pool.get(k) for k in p._pool_keys()}
    copies = {k: [t.clone() for t in (v if isinstance(v, tuple) else
                                      (getattr(v, "sorted_pk", v),))]
              for k, v in old.items()}
    _append_dim_rows(both, "part")
    sess.refresh()
    for k, v in old.items():
        now = sess.pool.get(k)
        was = v if isinstance(v, tuple) else (getattr(v, "sorted_pk", v),)
        for t, c in zip(was, copies[k]):
            assert_same(t, c)
        if "part" in k:          # the appended table's entries
            assert now is not v, k


# ---------------------------------------------------------------------------
# run_all: stacked execution ≡ per-query run()
# ---------------------------------------------------------------------------
def test_run_all_bit_exact(ref_data, ref_runs):
    _, sess, ref_sess = _fresh(ref_data)
    qs = [QUERY_IR[n]() for n in ALL_NAMES]
    batched = sess.run_all(qs)
    ref_batched = ref_sess.run_all([REF_QUERY_IR[n]() for n in ALL_NAMES],
                                   rewrite="off")
    for n, q, r, w in zip(ALL_NAMES, qs, batched, ref_batched):
        assert_same(r, compile_query(sess.catalog, q).run())
        assert_run_equal(r, w, exact=is_tree(n))
    assert sess.pool.stats() == ref_sess.pool.stats()
    sks = [stack_key(sess.compile(q)) for q in qs]
    real = [k for k in sks if k is not None]
    assert len(set(real)) < len(real)      # SSB flights share signatures
    again = sess.run_all(qs)                # cached stacked runners
    for r, r2 in zip(batched, again):
        assert_same(r, r2)


def test_run_all_accepts_builders_and_survives_refresh(ref_data):
    both, sess, _ = _fresh(ref_data)
    b = sess.query("lineorder").agg(revenue="sum(lo_revenue)", n="count")
    [r] = sess.run_all([b])
    assert_same(r, b.run())
    _append_dim_rows(both, "supplier")
    qs = [QUERY_IR[n]() for n in ("Q2.1", "Q2.2")]
    for q, r in zip(qs, sess.run_all(qs)):
        assert_same(r, compile_query(sess.catalog, q).run())


#: Order-date spans of a stack class's three members.
SPANS = ((0, 700), (500, 1500), (1200, 2555))


def _members(name):
    """Three members of ``name``'s class, in both packages: the registry
    query restricted to three spans of order dates (predicates live in the
    state, so the members share one online program)."""
    base, ref_base = QUERY_IR[name](), REF_QUERY_IR[name]()
    return ([dataclasses.replace(base, fact_preds=base.fact_preds + (
                Pred("lo_orderdate", "between", span),)) for span in SPANS],
            [dataclasses.replace(ref_base, fact_preds=ref_base.fact_preds + (
                RefPred("lo_orderdate", "between", span),))
             for span in SPANS])


@pytest.mark.parametrize("name,backend", [("P1.linear.year", "fused"),
                                          ("P3.tree.year", "nonfused")])
def test_stacked_class_launches_each_kernel_once(ref_data, monkeypatch,
                                                 name, backend):
    """A 3-member class with the kernel serve backend: ``run_all`` calls
    the class's kernel wrapper once (shared join columns and partials of
    one pool); stacking unpooled plans (no shared tensors) puts the members
    on a member axis, still one call.  Both equal each member's ``run()``
    bit for bit, and the reference's ``run_all`` to the parity rules."""
    kname = "fused_star_gather" if backend == "fused" else "tree_predict"
    mod = sys.modules[f"repro_torch.kernels.{kname}"]
    calls = []
    real = getattr(mod, kname)

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(mod, kname, counting)
    both, sess, ref_sess = _fresh(ref_data)
    members, ref_members = _members(name)
    kw = dict(backend=backend, serve_backend="kernel")
    plans = [sess.compile(q, **kw) for q in members]
    assert len({stack_key(p) for p in plans}) == 1
    solo = [p.run() for p in plans]
    calls.clear()
    got = sess.run_all(members, **kw)
    assert len(calls) == 1
    for g, s in zip(got, solo):
        assert_same(g, s)
    unpooled = [compile_query(sess.catalog, q, **kw) for q in members]
    runner = make_stacked_runner(unpooled[0]._online_fn)
    calls.clear()
    out = runner(stack_states([p._state for p in unpooled]))
    assert len(calls) == 1
    for slot, s in enumerate(solo):
        assert_same({k: v[slot] for k, v in out.items()},
                    {k: v for k, v in s.items()
                     if k not in ("rows", "groups")})
    ref_out = ref_sess.run_all(ref_members, rewrite="off", backend=backend)
    for g, w in zip(got, ref_out):
        assert_run_equal(g, w, exact=backend == "nonfused")


def test_stack_key_excludes_compacted_plans(catalog):
    q = QUERY_IR["Q1.1"]()
    assert stack_key(compile_query(catalog, q, select_capacity=4096)) is None
    assert stack_key(compile_query(catalog, q)) is not None


# ---------------------------------------------------------------------------
# Session cache-key normalization
# ---------------------------------------------------------------------------
def test_opts_key_defaults_collapse(ref_data):
    _, sess, _ = _fresh(ref_data)
    q = QUERY_IR["Q1.1"]()
    p = sess.compile(q)
    assert sess.compile(q, backend="auto") is p       # explicit default
    assert sess.compile(q, agg_backend="auto") is p
    assert sess.num_plans == 1
    assert sess.compile(q, backend="nonfused") is not p
    assert sess.num_plans == 2


def test_opts_key_serving_bucket_spellings(ref_data):
    _, sess, _ = _fresh(ref_data)
    q = QUERY_IR[predictive_query_names()[0]]()
    r = sess.serving(q, buckets=[64, 8])
    assert sess.serving(q, buckets=(8, 64)) is r      # order-insensitive
    assert sess.serving(q, buckets=(8, 64, 64)) is r  # dupes collapse
    assert sess.num_runtimes == 1
    assert sess.serving(q, buckets=(8, 32)) is not r
    assert sess.num_runtimes == 2


# ---------------------------------------------------------------------------
# Unified explain surface
# ---------------------------------------------------------------------------
def test_explain_unified(ref_data):
    both, sess, ref_sess = _fresh(ref_data)
    rep = sess.bind(QUERY_IR["Q2.1"]()).explain()
    ref_rep = ref_sess.bind(REF_QUERY_IR["Q2.1"]()).explain(rewrite="off")
    assert isinstance(rep, ExplainReport) and rep.kind == "compiled"
    assert _keys(rep.shared_artifacts) == _keys(ref_rep.shared_artifacts)
    assert str(rep)
    d = rep.as_dict()
    assert d["kind"] == "compiled" and isinstance(d["extras"], dict)
    assert set(d) == set(ref_rep.as_dict())

    name = predictive_query_names()[0]
    srep = sess.serving(QUERY_IR[name](), buckets=(4,)).explain()
    assert srep.kind == "serving" and srep.shared_artifacts

    with sess.scheduler(auto_start=False) as sched:
        sched.register(sess.serving(QUERY_IR[name](), buckets=(4,)),
                       name="p0")
        _append_dim_rows(both, QUERY_IR[name]().arms[0].table)
        sched.refresh()
        crep = sched.explain()
        assert crep.kind == "scheduler"
        assert any("p0:" in line for line in crep.trail)


def test_deprecated_entry_points_warn(catalog):
    from repro_torch.data import compiled_plan, generate_ssb
    data = generate_ssb(sf=1, scale=0.0005, seed=5, device="cpu")
    with pytest.warns(DeprecationWarning, match="migration table"):
        plan = compiled_plan("Q1.1", data)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert compiled_plan("Q1.1", data) is plan     # the session cache
    raw = {n: catalog[n] for n in catalog}
    with pytest.warns(DeprecationWarning, match="plain mapping"):
        compile_query(raw, QUERY_IR["Q1.1"]())
    with pytest.warns(DeprecationWarning, match="plain mapping"):
        compile_serving(raw, QUERY_IR[predictive_query_names()[0]](),
                        buckets=(4,))
