"""The rewrite engine on the port against the JAX reference, case for case
with ``tests/test_rewrite.py``, plus the registry's rewritten plans.

The same seeded numpy columns build a reference ``Table`` and a port
``Table`` (on the CPU).  Per case: the port's ``rewrite_query`` gives the
reference's rewritten IR (content-equal, model arrays by value) and trail,
and the port's plans with ``rewrite="on"`` and ``"off"`` equal the port's
float64 numpy oracle across fused/nonfused × segment/matmul and the
reference's ``run()`` — all **bit for bit**: the data is integer-valued and
every rule is exact.  ``P3.tree.year`` and ``P4.tree.select.region`` carry
the reference's rewrite trail and ``plan.reason`` segment; their results
equal the reference's (rows and groups exact, tree sums exact).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.query as RQ
from repro.core.fusion.operators import DecisionTreeGEMM as RefTree
from repro.core.fusion.operators import LinearOperator as RefLinear
from repro.core.fusion.operators import tree_from_arrays as ref_tree
from repro.core.laq import Catalog as RefCatalog
from repro.core.laq import Table as RefTable
from repro.core.laq.selection import Pred as RefPred
from repro.core.query.rewrite import _col_bounds as ref_col_bounds
from repro.data import QUERY_IR as REF_QUERY_IR
from repro_torch.core.laq import Catalog, Pred, Table
from repro_torch.core.query import (PREDICTION, Aggregate, ArmSpec,
                                    ArtifactPool, ChainLink, PredictiveQuery,
                                    RewriteResult, Session, compile_query,
                                    compile_serving, rewrite_query)
from repro_torch.core.query.multiquery import join_key
from repro_torch.core.query.rewrite import _col_bounds, feature_sites
from repro_torch.core.query.workload import _compare, np_oracle
from repro_torch.data import QUERY_IR
from torch_parity import (assert_run_equal, assert_same, port_catalog,
                          port_query, ref_ssb_catalog, to_np)

COMBOS = [(b, a) for b in ("fused", "nonfused")
          for a in ("segment", "matmul")]


# --------------------------------------------------------------------------
# Schema: one star dimension with three features, integer-valued
# --------------------------------------------------------------------------
def _both(columns):
    """``{name: (cols, key_cols, capacity)}`` as reference and port tables."""
    ref, port = {}, {}
    for name, (cols, keys, cap) in columns.items():
        ref[name] = RefTable.from_columns(name, cols, key_cols=keys,
                                          capacity=cap)
        port[name] = Table.from_columns(name, cols, key_cols=keys,
                                        capacity=cap, device="cpu")
    return ref, port


def _star_columns(seed=0, n=48):
    rng = np.random.default_rng(seed)
    d = {"d_pk": np.arange(8), "d_f0": rng.integers(-4, 5, 8),
         "d_f1": rng.integers(-4, 5, 8), "d_f2": rng.integers(-4, 5, 8)}
    fact = {"fk": rng.integers(0, 10, n),          # some FK misses
            "f_g": rng.integers(0, 3, n), "m": rng.integers(-4, 5, n)}
    return {"d": (d, ("d_pk",), 16), "f": (fact, ("fk", "f_g"), 64)}


def _star_tables(seed=0):
    return _both(_star_columns(seed))


def _tree():
    # node0: f0 > 0; node1: f1 > 1; node2: f0 > -1.  Leaf 3 (right-right)
    # ⟺ f0 > 0 ∧ f0 > -1 ⟺ d_f0 > 0 — a single distilled predicate.
    return ref_tree(np.array([0, 1, 0]), np.array([0., 1., -1.], np.float32),
                    3)


def _q(model, *, model_preds=(), arm_preds=(), aggs=None, groups=True):
    """``test_rewrite._q``: the reference's query (port it with
    ``port_query``)."""
    arm = RQ.ArmSpec("d", "fk", "d_pk", ("d_f0", "d_f1", "d_f2"),
                     tuple(arm_preds))
    if aggs is None:
        aggs = (RQ.Aggregate("m", "sum", "rev"),
                RQ.Aggregate("*", "count", "n"))
    gks = (RQ.GroupKey("fact", "f_g", 3),) if groups else ()
    return RQ.PredictiveQuery("f", (arm,), (), model, gks, tuple(aggs),
                              3 if groups else 8,
                              model_preds=tuple(model_preds))


def _pred_aggs():
    return (RQ.Aggregate(PREDICTION, "sum", "p"),
            RQ.Aggregate("*", "count", "n"))


def _rewrite_both(ref_t, tables, ref_q):
    """Both packages' rewrite of one query: the port's result, after
    checking it against the reference's (trail, and IR by content)."""
    q = port_query(ref_q)
    rw = rewrite_query(tables, q)
    ref_rw = RQ.rewrite_query(ref_t, ref_q)
    assert isinstance(rw, RewriteResult)
    assert rw.trail == ref_rw.trail
    assert rw.query == port_query(ref_rw.query)
    return rw


def _check_on_off(ref_t, tables, ref_q, rule, extra=()):
    """Rewrite on and off across every combo: both equal the oracle bit
    for bit, ``rule`` is in the trail (the reference's), and the default
    plan equals the reference's."""
    q = port_query(ref_q)
    want = np_oracle(tables, q)
    ref_on = RQ.compile_query(RefCatalog(dict(ref_t)), ref_q)
    for backend, agg_backend in COMBOS:
        kw = dict(backend=backend, agg_backend=agg_backend)
        on = compile_query(Catalog(dict(tables)), q, **kw)
        off = compile_query(Catalog(dict(tables)), q, rewrite="off", **kw)
        assert any(rule in t for t in on._rewrites), on._rewrites
        assert on._rewrites == ref_on._rewrites
        for name in (rule, *extra):
            assert name in on.plan.reason
        assert off._rewrites == ()
        assert "rewrite=[" not in off.plan.reason
        lbl = f"{backend}/{agg_backend}"
        assert _compare(on.run(), want, q, f"on {lbl}") == []
        assert _compare(off.run(), want, q, f"off {lbl}") == []
    plan = compile_query(Catalog(dict(tables)), q)
    assert_same(plan.run(), ref_on.run())
    return plan


def _compile_both(ref_t, tables, ref_q, label):
    """Rewrite on and off against the oracle (the cases no rule fires
    for, or only some)."""
    q = port_query(ref_q)
    want = np_oracle(tables, q)
    for rewrite in ("on", "off"):
        res = compile_query(Catalog(dict(tables)), q, rewrite=rewrite).run()
        assert _compare(res, want, q, f"{label} {rewrite}") == []


# --------------------------------------------------------------------------
# tree→predicate distillation
# --------------------------------------------------------------------------
def test_distill_single_leaf_drops_model():
    ref_t, tables = _star_tables()
    ref_q = _q(_tree(), model_preds=[RQ.PredictionFilter(3, "==", 1.0)])
    plan = _check_on_off(ref_t, tables, ref_q, "distill_tree_filter",
                         extra=("model dropped",))
    # The rewritten IR is a pure relational query: model gone, the leaf's
    # path compiled into one dimension predicate, features dropped.
    rw = _rewrite_both(ref_t, tables, ref_q)
    assert rw.changed
    assert rw.query.model is None and rw.query.model_preds == ()
    assert rw.query.arms[0].feature_cols == ()
    preds = rw.query.arms[0].preds
    assert [(p.col, p.op, p.value) for p in preds] == [("d_f0", ">", 0.0)]
    rep = plan.explain()
    assert dict(rep.extras)["rewrites"] == plan._rewrites
    assert rep.as_dict()["extras"]["rewrites"] == plan._rewrites


def test_distill_vacuous_filter_dropped():
    ref_t, tables = _star_tables(1)
    # >= 0 holds for every one-hot output: the filter is vacuous.
    ref_q = _q(_tree(), model_preds=[RQ.PredictionFilter(0, ">=", 0.0)],
               aggs=_pred_aggs())
    rw = _rewrite_both(ref_t, tables, ref_q)
    assert rw.query.model_preds == () and rw.query.model is not None
    assert any("vacuous" in t for t in rw.trail)
    _check_on_off(ref_t, tables, ref_q, "distill_tree_filter")


def test_distill_blocked_by_prediction_aggregate():
    ref_t, tables = _star_tables(2)
    ref_q = _q(_tree(), model_preds=[RQ.PredictionFilter(3, "==", 1.0)],
               aggs=(RQ.Aggregate(PREDICTION, "sum", "p"),))
    rw = _rewrite_both(ref_t, tables, ref_q)
    # Predictions still feed an aggregate: the model must stay.
    assert rw.query.model is not None
    _compile_both(ref_t, tables, ref_q, "pred-agg")


def test_distill_multi_leaf_not_expressible():
    ref_t, tables = _star_tables(3)
    # != selects 3 of 4 leaves — an OR of paths; the rule must refuse.
    ref_q = _q(_tree(), model_preds=[RQ.PredictionFilter(3, "!=", 1.0)])
    rw = _rewrite_both(ref_t, tables, ref_q)
    assert rw.query.model is not None
    _compile_both(ref_t, tables, ref_q, "multi-leaf")


def test_distilled_predicates_compare_as_the_tree_does():
    """Distilled ``feature > v`` / ``<= v`` predicates on float32 feature
    columns compare in float32, as the tree's ``x·F > v`` does: a value
    equal to a threshold and thresholds that are not integers."""
    rng = np.random.default_rng(21)
    vals = np.array([-2, -1.5, -0.5, 0, 0.25, 0.5, 1, 1.5, 2, 2.5],
                    np.float32)
    d = {"d_pk": np.arange(16), "d_f0": rng.choice(vals, 16),
         "d_f1": rng.choice(vals, 16), "d_f2": rng.choice(vals, 16)}
    fact = {"fk": rng.integers(0, 18, 60), "f_g": rng.integers(0, 3, 60),
            "m": rng.integers(-4, 5, 60)}
    ref_t, tables = _both({"d": (d, ("d_pk",), 20),
                           "f": (fact, ("fk", "f_g"), 64)})
    # node0: f0 > 0.5; node1: f1 > -0.5; node2: f2 > 1.5 (a threshold some
    # rows equal exactly).
    tree = ref_tree(np.array([0, 1, 2]),
                    np.array([0.5, -0.5, 1.5], np.float32), 3)
    for leaf in range(4):
        ref_q = _q(tree, model_preds=[RQ.PredictionFilter(leaf, "==",
                                                          1.0)])
        rw = _rewrite_both(ref_t, tables, ref_q)
        assert rw.query.model is None, rw.trail
        on = compile_query(Catalog(dict(tables)), port_query(ref_q)).run()
        off = compile_query(Catalog(dict(tables)), port_query(ref_q),
                            rewrite="off").run()
        assert_same(on, off)
        assert_same(on, RQ.compile_query(RefCatalog(dict(ref_t)),
                                         ref_q).run())


# --------------------------------------------------------------------------
# constant-input folding (+ zero-weight projection riding along)
# --------------------------------------------------------------------------
def test_fold_constants_into_bias():
    ref_t, tables = _star_tables(4)
    model = RefLinear(jnp.asarray([[2., 1.], [0., 0.], [3., -1.]],
                                  jnp.float32))
    ref_q = _q(model, arm_preds=[RefPred("d_f0", "==", 2)],
               aggs=_pred_aggs())
    plan = _check_on_off(ref_t, tables, ref_q, "fold_constant_inputs")
    rw = _rewrite_both(ref_t, tables, ref_q)
    # d_f0 pinned to 2 → bias 2·[2,1] = [4,2]; d_f1's zero row projected.
    assert any("project_zero_weights" in t for t in rw.trail)
    m = rw.query.model
    np.testing.assert_array_equal(to_np(m.bias), [4., 2.])
    assert tuple(m.L.shape) == (1, 2)
    assert rw.query.arms[0].feature_cols == ("d_f2",)
    assert any("fold_constant_inputs" in t for t in plan._rewrites)


def test_fold_keeps_at_least_one_feature():
    ref_t, tables = _star_tables(5)
    model = RefLinear(jnp.asarray([[2.]], jnp.float32))
    arm = RQ.ArmSpec("d", "fk", "d_pk", ("d_f0",),
                     (RefPred("d_f0", "==", 1),))
    ref_q = RQ.PredictiveQuery("f", (arm,), (), model, (),
                               (RQ.Aggregate(PREDICTION, "sum", "p"),), 8)
    rw = _rewrite_both(ref_t, tables, ref_q)
    # Pinning the only feature would leave an empty model: refuse.
    assert not any("fold" in t for t in rw.trail)
    _compile_both(ref_t, tables, ref_q, "single-feature")


# --------------------------------------------------------------------------
# predicate-implied tree pruning
# --------------------------------------------------------------------------
def test_prune_tree_branches():
    ref_t, tables = _star_tables(6)
    # d_f0 > 2 decides node0 (f0>0) and node2 (f0>-1) True; only node1
    # (f1 > 1) survives, then the dead f0/f2 rows project out.
    ref_q = _q(_tree(), arm_preds=[RefPred("d_f0", ">", 2)],
               aggs=_pred_aggs())
    plan = _check_on_off(ref_t, tables, ref_q, "prune_tree_branches")
    rw = _rewrite_both(ref_t, tables, ref_q)
    assert any("3->1 nodes" in t for t in rw.trail)
    assert any("project_zero_weights" in t for t in rw.trail)
    m = rw.query.model
    assert m.F.shape[1] == 1 and rw.query.arms[0].feature_cols == ("d_f1",)
    assert plan._rewrites


# --------------------------------------------------------------------------
# Interval analysis: stacked predicates on one column (strictness merging)
# --------------------------------------------------------------------------
def _bounds_both(specs):
    """``_col_bounds`` in both packages over the same predicate specs; the
    port's, after checking every field equals the reference's."""
    b = _col_bounds([Pred(*s) for s in specs], "x")
    r = ref_col_bounds([RefPred(*s) for s in specs], "x")
    assert dataclasses.asdict(b) == dataclasses.asdict(r)
    return b


def test_col_bounds_between_clears_stale_strictness():
    # 'between' after '>' replaces the strict lo=2 with a NON-strict lo=6:
    # x=6 satisfies both predicates, so `x > 6` must stay undecided.
    b = _bounds_both([("x", ">", 2), ("x", "between", (6, 10))])
    assert (b.lo, b.lo_strict, b.hi, b.hi_strict) == (6.0, False, 10.0,
                                                      False)
    assert b.forced(np.float32(6.0)) is None
    assert b.forced(np.float32(5.0)) is True
    assert b.forced(np.float32(10.0)) is False


def test_col_bounds_le_clears_stale_lt_strictness():
    # '<=' tightening past a strict '<' must clear hi_strict: x may be 8,
    # so the finite domain {5, 8} is not pinned to a single value.
    b = _bounds_both([("x", "<", 10), ("x", "<=", 8), ("x", "in", (5, 8))])
    assert (b.hi, b.hi_strict) == (8.0, False)
    assert b.pinned() is None


def test_col_bounds_strictness_kept_at_equal_value():
    # A strict bound at the same value is the tighter one either way round.
    for specs in ([("x", ">", 6), ("x", "between", (6, 10))],
                  [("x", "between", (6, 10)), ("x", ">", 6)]):
        b = _bounds_both(specs)
        assert b.lo_strict and b.forced(np.float32(6.0)) is True
    b = _bounds_both([("x", "<", 8), ("x", "between", (0, 8))])
    assert b.hi_strict


def test_col_bounds_pin_via_stacked_inequalities():
    b = _bounds_both([("x", ">=", 2), ("x", "<=", 2)])
    assert b.pinned() == np.float32(2.0)
    # A strict bound at the pin value empties the interval — no pin.
    b = _bounds_both([("x", ">", 2), ("x", "<=", 2)])
    assert b.pinned() is None


def test_prune_keeps_boundary_node_under_stacked_preds():
    # [d_f0 > -3, d_f0 between (0, 4)] admits d_f0 == 0, which takes
    # node0's (f0 > 0) *left* branch: node2 (f0 > -1) is decided, node0
    # must survive.
    ref_t, tables = _star_tables(16)
    ref_q = _q(_tree(), arm_preds=[RefPred("d_f0", ">", -3),
                                   RefPred("d_f0", "between", (0, 4))],
               aggs=_pred_aggs())
    _check_on_off(ref_t, tables, ref_q, "prune_tree_branches")
    rw = _rewrite_both(ref_t, tables, ref_q)
    assert any("3->2 nodes" in t for t in rw.trail)


def test_fold_refuses_false_pin_from_stale_strictness():
    # [d_f0 < 4, d_f0 <= 2, d_f0 in (0, 2)] leaves both 0 and 2 feasible:
    # nothing may fold into the bias.
    ref_t, tables = _star_tables(15)
    model = RefLinear(jnp.asarray([[2., 1.], [1., 2.], [3., -1.]],
                                  jnp.float32))
    ref_q = _q(model, arm_preds=[RefPred("d_f0", "<", 4),
                                 RefPred("d_f0", "<=", 2),
                                 RefPred("d_f0", "in", (0, 2))],
               aggs=_pred_aggs())
    rw = _rewrite_both(ref_t, tables, ref_q)
    assert not any("fold_constant_inputs" in t for t in rw.trail)
    _compile_both(ref_t, tables, ref_q, "stale-strict")


def test_fold_pins_via_stacked_inequalities():
    # >= 2 and <= 2 together pin d_f0 without an equality predicate.
    ref_t, tables = _star_tables(17)
    model = RefLinear(jnp.asarray([[2., 1.], [1., 2.], [3., -1.]],
                                  jnp.float32))
    ref_q = _q(model, arm_preds=[RefPred("d_f0", ">=", 2),
                                 RefPred("d_f0", "<=", 2)],
               aggs=_pred_aggs())
    _check_on_off(ref_t, tables, ref_q, "fold_constant_inputs")
    rw = _rewrite_both(ref_t, tables, ref_q)
    np.testing.assert_array_equal(to_np(rw.query.model.bias), [4., 2.])
    assert rw.query.arms[0].feature_cols == ("d_f1", "d_f2")


def test_malformed_multi_feature_node_refused():
    # An F column with two 1s (a sum-of-features node): distill refuses
    # and prune skips that node rather than treat it as testing only the
    # argmax feature.
    ref_t, tables = _star_tables(14)
    t = _tree()
    F = np.asarray(t.F).copy()
    F[2, 0] = 1.0                      # node0 now tests d_f0 + d_f2
    m = RefTree(jnp.asarray(F), t.v, t.H, t.h)
    ref_q = _q(m, model_preds=[RQ.PredictionFilter(3, "==", 1.0)])
    rw = _rewrite_both(ref_t, tables, ref_q)
    assert rw.query.model is not None and not rw.changed
    _compile_both(ref_t, tables, ref_q, "malformed")
    ref_q2 = _q(m, arm_preds=[RefPred("d_f0", ">", 2)], aggs=_pred_aggs())
    rw2 = _rewrite_both(ref_t, tables, ref_q2)
    assert any("3->2 nodes" in s for s in rw2.trail)
    _compile_both(ref_t, tables, ref_q2, "prune")


# --------------------------------------------------------------------------
# Engine plumbing: knob validation, session cache keys, serving, sites
# --------------------------------------------------------------------------
def test_rewrite_knob_validated():
    _, tables = _star_tables(7)
    q = port_query(_q(None, groups=True))
    with pytest.raises(ValueError, match="rewrite"):
        compile_query(Catalog(dict(tables)), q, rewrite="sometimes")


def test_key_columns_never_distilled():
    # A tree over a column that is also a key column must not rewrite:
    # Pred.mask compares the int key array, not the f32 feature.
    rng = np.random.default_rng(8)
    cols = _star_columns(8)
    cols["d"] = ({"d_pk": np.arange(8), "d_f0": rng.integers(-4, 5, 8)},
                 ("d_pk", "d_f0"), 16)
    ref_t, tables = _both(cols)
    arm = RQ.ArmSpec("d", "fk", "d_pk", ("d_f0",), ())
    ref_q = RQ.PredictiveQuery(
        "f", (arm,), (), ref_tree(np.array([0]), np.array([0.], np.float32),
                                  1),
        (), (RQ.Aggregate("m", "sum", "rev"),), 8,
        model_preds=(RQ.PredictionFilter(1, "==", 1.0),))
    rw = _rewrite_both(ref_t, tables, ref_q)
    assert rw.query.model is not None


def test_session_cache_distinguishes_model_preds():
    ref_t, tables = _star_tables(9)
    sess = Session(Catalog(dict(tables)))
    ref_q0 = _q(_tree(), aggs=(RQ.Aggregate(PREDICTION, "sum", "p"),))
    ref_q1 = dataclasses.replace(
        ref_q0, model_preds=(RQ.PredictionFilter(3, "==", 1.0),))
    q0, q1 = port_query(ref_q0), port_query(ref_q1)
    p0, p1 = sess.compile(q0), sess.compile(q1)
    assert p0 is not p1
    assert sess.compile(port_query(ref_q1)) is p1   # cache hit on re-bind
    assert _compare(p0.run(), np_oracle(tables, q0), q0, "unfiltered") == []
    assert _compare(p1.run(), np_oracle(tables, q1), q1, "filtered") == []


def test_builder_predict_where_and_refresh():
    ref_t, tables = _star_tables(10)
    cat, ref_cat = Catalog(dict(tables)), RefCatalog(dict(ref_t))
    sess = Session(cat)
    plan = (sess.query("f")
            .join("d", on=("fk", "d_pk"),
                  features=["d_f0", "d_f1", "d_f2"])
            .predict(port_query(_q(_tree())).model, where=[(3, "==", 1.0)])
            .group_by(("fact", "f_g", 3), num_groups=3)
            .agg(rev="sum(m)", n="count")
            .compile())
    assert any("distill" in t for t in plan._rewrites)
    ref_q = _q(_tree(), model_preds=[RQ.PredictionFilter(3, "==", 1.0)])
    q = port_query(ref_q)
    assert plan._rewrites == RQ.compile_query(ref_cat, ref_q)._rewrites
    snap = {n: cat[n] for n in cat}
    assert _compare(plan.run(), np_oracle(snap, q), q, "builder") == []
    # Rewrites read no data: appends refresh through the same delta paths.
    rng = np.random.default_rng(10)
    rows = {"fk": rng.integers(0, 10, 4), "f_g": rng.integers(0, 3, 4),
            "m": rng.integers(-4, 5, 4)}
    cat.append("f", rows)
    line = plan.refresh()
    assert line.startswith("refresh=delta(f+1;"), line
    snap = {n: cat[n] for n in cat}
    assert _compare(plan.run(), np_oracle(snap, q), q, "refreshed") == []
    assert_same(plan.run(), compile_query(Catalog(snap), q).run())


def test_compile_serving_rejects_model_preds():
    _, tables = _star_tables(11)
    q = port_query(_q(_tree(), model_preds=[RQ.PredictionFilter(3, "==",
                                                                1.0)],
                      groups=False))
    with pytest.raises(ValueError, match="model_preds"):
        compile_serving(Catalog(dict(tables)), q)


def test_feature_sites_global_order():
    arm0 = ArmSpec("d", "fk", "d_pk", ("d_f0",), (),
                   links=(ChainLink("e", "d_to_e", "e_pk", ("e_f0",)),))
    arm1 = ArmSpec("g", "fk2", "g_pk", ("g_f0",), ())
    q = PredictiveQuery("f", (arm0, arm1), (), None, (),
                        (Aggregate("m", "sum", "rev"),), 8)
    sites = feature_sites(q)
    assert [(s.table, s.col) for s in sites] == [
        ("d", "d_f0"), ("e", "e_f0"), ("g", "g_f0")]


# --------------------------------------------------------------------------
# Hop-level pooled chains
# --------------------------------------------------------------------------
def _chain_columns(seed=0, n=40):
    rng = np.random.default_rng(seed)
    e2 = {"e2_pk": np.arange(4), "e2_f0": rng.integers(-4, 5, 4)}
    e1 = {"e1_pk": np.arange(6), "e1_to_e2": rng.integers(0, 6, 6),
          "e1_f0": rng.integers(-4, 5, 6)}
    d = {"d_pk": np.arange(8), "d_to_e1": rng.integers(0, 8, 8),
         "d_f0": rng.integers(-4, 5, 8)}
    fact = {"fk": rng.integers(0, 10, n), "f_g": rng.integers(0, 3, n),
            "m": rng.integers(-4, 5, n)}
    return {"e2": (e2, ("e2_pk",), 8), "e1": (e1, ("e1_pk", "e1_to_e2"), 12),
            "d": (d, ("d_pk", "d_to_e1"), 16), "f": (fact, ("fk", "f_g"), 64)}


def _chain_q(depth2: bool):
    links = (RQ.ChainLink("e1", "d_to_e1", "e1_pk", ("e1_f0",)),)
    feats = ["d_f0", "e1_f0"]
    if depth2:
        links += (RQ.ChainLink("e2", "e1_to_e2", "e2_pk", ("e2_f0",),
                               parent="e1"),)
        feats.append("e2_f0")
    arm = RQ.ArmSpec("d", "fk", "d_pk", ("d_f0",), (), links=links)
    model = RefLinear(jnp.asarray(np.ones((len(feats), 1)), jnp.float32))
    return RQ.PredictiveQuery("f", (arm,), (), model, (),
                              (RQ.Aggregate(PREDICTION, "sum", "p"),
                               RQ.Aggregate("*", "count", "n")), 8)


def test_shared_hop_pooled_once_across_chains():
    ref_t, tables = _both(_chain_columns())
    cat, ref_cat = Catalog(dict(tables)), RefCatalog(dict(ref_t))
    pool, ref_pool = ArtifactPool(cat), RQ.ArtifactPool(ref_cat)
    ref_q1, ref_q2 = _chain_q(depth2=True), _chain_q(depth2=False)
    q1, q2 = port_query(ref_q1), port_query(ref_q2)
    p1, p2 = (compile_query(cat, q, pool=pool) for q in (q1, q2))
    r1, r2 = (RQ.compile_query(ref_cat, q, pool=ref_pool)
              for q in (ref_q1, ref_q2))
    st = pool.stats()
    assert st["by_kind"].get("chain") == 2     # distinct chain contents
    for k in ("entries", "hits", "misses", "by_kind"):
        assert st[k] == ref_pool.stats()[k], k
    # The d→e1 hop probe is ONE pooled entry, referenced by both chains.
    hop = join_key("d", "d_to_e1", "e1", "e1_pk")
    assert pool.refcount(hop) == 2 == ref_pool.refcount(hop)
    snap = {n: cat[n] for n in cat}
    assert _compare(p1.run(), np_oracle(snap, q1), q1, "hop-q1") == []
    assert _compare(p2.run(), np_oracle(snap, q2), q2, "hop-q2") == []
    # Appending to the deep link refreshes the shared hop exactly once.
    rng = np.random.default_rng(1)
    rows = {"e1_pk": np.array([6, 7]), "e1_to_e2": rng.integers(0, 6, 2),
            "e1_f0": rng.integers(-4, 5, 2)}
    cat.append("e1", rows)
    ref_cat.append("e1", rows)
    assert [p.refresh() for p in (p1, p2)] == [r.refresh() for r in (r1, r2)]
    assert pool.update_count(hop) == 1 == ref_pool.update_count(hop)
    snap = {n: cat[n] for n in cat}
    assert _compare(p1.run(), np_oracle(snap, q1), q1, "hop-q1r") == []
    assert _compare(p2.run(), np_oracle(snap, q2), q2, "hop-q2r") == []
    for p, r in ((p1, r1), (p2, r2)):
        assert_same(p.run(), r.run())
    # Releasing both plans drops the chains and their hop references.
    p1.close()
    p2.close()
    assert pool.stats()["entries"] == 0


# --------------------------------------------------------------------------
# The registry's rewritten plans: P3 and P4 carry the reference's trail
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ssb():
    ref_cat = ref_ssb_catalog()
    return ref_cat, port_catalog(ref_cat)


@pytest.mark.parametrize("name,trail,k", [
    ("P3.tree.year", "project_zero_weights(projected date.d_month)", (5, 4)),
    ("P4.tree.select.region",
     "project_zero_weights(projected supplier.s_city)", (3, 2)),
])
def test_registry_plan_carries_reference_rewrite(ssb, name, trail, k):
    ref_cat, cat = ssb
    ref = RQ.compile_query(ref_cat, REF_QUERY_IR[name]())
    plan = compile_query(cat, QUERY_IR[name]())
    assert plan._rewrites == ref._rewrites == (trail,)
    seg = [r for r in plan.plan.reason.split("; ")
           if r.startswith("rewrite=[")]
    assert seg == [r for r in ref.plan.reason.split("; ")
                   if r.startswith("rewrite=[")] == [f"rewrite=[{trail}]"]
    assert (plan._source.model.k, plan.query.model.k) == k
    assert plan.query.model.k == ref.query.model.k
    assert plan.query == port_query(ref.query)
    assert_run_equal(plan.run(), ref.run(), exact=True)
    off = compile_query(cat, QUERY_IR[name](), rewrite="off")
    assert off._rewrites == () and off.query.model.k == k[0]
    assert_same(plan.run(), off.run())
    assert_same(plan.predictions(), off.predictions())
    ids = torch.arange(0, cat["lineorder"].capacity, 7)
    assert_same(plan.predict_rows(ids), off.predict_rows(ids))


@pytest.mark.parametrize("name", ["P1.linear.year", "P2.linear.select.scalar",
                                  "P3.tree.year", "P4.tree.select.region"])
def test_estimate_query_cost_equals_reference(name):
    """The cost the rewrite-versus-original choice reads, both packages."""
    from repro.core.query.planner import estimate_query_cost as ref_cost
    from repro_torch.core.query import estimate_query_cost
    ref_model, model = REF_QUERY_IR[name]().model, QUERY_IR[name]().model
    for fact_rows, dims, groups, ops in (
            (6_000_000, [20_000, 2556], 0, ("sum",)),
            (64, [16, 32, 8], 8, ("sum", "count", "mean")),
            (1, [], 8192, ("min", "max"))):
        for m, rm in ((model, ref_model), (None, None)):
            kw = dict(num_groups=groups, out_width=m.l if m else 1,
                      agg_ops=ops, batches_per_update=1000.0)
            assert estimate_query_cost(m, fact_rows, dims, platform="cpu",
                                       **kw) == ref_cost(
                rm, fact_rows, dims, platform="cpu", **kw)
