"""Port parity: the predictive-query compiler (``repro_torch.core.query``)
vs ``repro.core.query.compile_query(..., rewrite="off")`` on a Catalog.

Both packages read the same SSB tables (``scale=0.0005``): the reference's
are carried into the port through ``repro_torch.interop``.  Tolerances:
  * exact — surviving-row counts, group codes, every tree-head output
    (predictions, ``predict_rows``, and the leaf counts summed per group,
    which are integers);
  * rtol 1e-6 (1 ulp) — linear-head predictions (the prefuse and model
    matmuls round by library and shape), with atol 1e-6 of the prediction
    matrix's largest magnitude: a fused row sums partials that each carry
    their own ulp;
  * rtol 1e-5 — float aggregates summed over rows.

P1–P4 over the whole backend matrix, ``predict_rows`` included, are in
the four ``test_torch_query_<backend>_<serve>.py`` files.
"""
import numpy as np
import jax.numpy as jnp
import pytest

import repro.core.query as RQ
import repro_torch.core.query as TQ
from repro.core.fusion import LinearOperator as RefLinear
from repro.core.query.planner import \
    estimate_query_cost as ref_estimate_query_cost
from repro.data import QUERY_IR as REF_QUERY_IR
from repro.data import predictive_query_names as ref_predictive_names
from repro.data import query_groups as ref_query_groups
from repro_torch.core.fusion import random_tree
from repro_torch.data import QUERY_IR, predictive_query_names, query_groups
from repro_torch.interop import model_from_arrays
from torch_parity import (assert_run_equal, is_tree, port_tables,
                          ref_plan, ref_ssb_catalog, to_np)

SSB_NAMES = [n for n in REF_QUERY_IR if n.startswith("Q")]
PRED_NAMES = ref_predictive_names()


@pytest.fixture(scope="module")
def ref_cat():
    return ref_ssb_catalog()


@pytest.fixture(scope="module")
def tables(ref_cat):
    return port_tables(ref_cat)


@pytest.fixture(scope="module")
def ref_plans():
    """Reference plans compiled once per option set."""
    return {}


# ---------------------------------------------------------------- registry
def test_registry_matches_reference():
    assert list(QUERY_IR) == list(REF_QUERY_IR)
    assert predictive_query_names() == PRED_NAMES
    assert query_groups() == ref_query_groups()
    for name in QUERY_IR:
        got, want = QUERY_IR[name](), REF_QUERY_IR[name]()
        assert got.fact == want.fact and got.num_groups == want.num_groups
        assert [(a.table, a.fk_col, a.pk_col, a.feature_cols,
                 [(p.col, p.op, p.value) for p in a.preds])
                for a in got.arms] == [
            (a.table, a.fk_col, a.pk_col, a.feature_cols,
             [(p.col, p.op, p.value) for p in a.preds]) for a in want.arms]
        assert [(p.col, p.op, p.value) for p in got.fact_preds] == [
            (p.col, p.op, p.value) for p in want.fact_preds]
        assert [(g.table, g.col, g.bound, g.offset)
                for g in got.group_keys] == [
            (g.table, g.col, g.bound, g.offset) for g in want.group_keys]
        assert [(a.value, a.op, a.name) for a in got.aggregates] == [
            (a.value, a.op, a.name) for a in want.aggregates]
        if want.model is None:
            assert got.model is None
            continue
        fields = ("L",) if hasattr(want.model, "L") else ("F", "v", "H", "h")
        for f in fields:   # same numpy draws → the same weights, exactly
            np.testing.assert_array_equal(to_np(getattr(got.model, f)),
                                          to_np(getattr(want.model, f)))


# ------------------------------------------------- every query, planner's way
@pytest.mark.parametrize("name", SSB_NAMES + PRED_NAMES)
def test_query_default_plan_matches_reference(name, tables, ref_cat,
                                              ref_plans):
    want = ref_plan(ref_plans, ref_cat, name)
    got = TQ.compile_query(tables, QUERY_IR[name]())
    assert (got.backend, got.join_backend, got.agg_backend) == (
        want.backend, want.join_backend, want.agg_backend)
    assert got.serve_backend == "torch"       # no card: no kernel to pick
    assert got.selectivity == want.selectivity
    assert_run_equal(got.run(), want.run(),
                      exact=want.query.model is not None and is_tree(name))
    report = got.explain()
    assert report.kind == "compiled" and "serve=torch" in str(report)
    assert set(report.as_dict()) == set(want.explain().as_dict())


def test_select_capacity_matches_reference(tables, ref_cat, ref_plans):
    want = ref_plan(ref_plans, ref_cat, "Q1.1", select_capacity=512)
    got = TQ.compile_query(tables, QUERY_IR["Q1.1"](), select_capacity=512)
    assert_run_equal(got.run(), want.run(), exact=False)


# ------------------------------------------------------------------ planner
@pytest.mark.parametrize("G,l,ops", [(8, 4, ("sum",)), (8192, 8, ("sum",)),
                                     (5, 3, ("mean", "max")),
                                     (64, 1, ("count",))])
def test_plan_aggregation_matches_reference(G, l, ops):
    got = TQ.plan_aggregation(1e6, G, l, ops=ops)
    want = RQ.plan_aggregation(1e6, G, l, ops=ops, platform="cpu")
    assert (got.backend, got.matmul_flops, got.segment_flops) == (
        want.backend, want.matmul_flops, want.segment_flops)


@pytest.mark.parametrize("name", PRED_NAMES)
def test_plan_query_and_cost_match_reference(name):
    ref_q, q = REF_QUERY_IR[name](), QUERY_IR[name]()
    for rows, dims in ((3000, (100, 8, 2555)), (60_000_000,
                                                (800_000, 20_000, 2555))):
        want = RQ.plan_query(ref_q.model, rows, dims, num_groups=8,
                             out_width=ref_q.model.l, platform="cpu")
        got = TQ.plan_query(q.model, rows, dims, num_groups=8,
                            out_width=q.model.l, platform="cpu")
        assert (got.backend, got.join_backend, got.agg.backend) == (
            want.backend, want.join_backend, want.agg.backend)
        assert TQ.estimate_query_cost(q.model, rows, dims, num_groups=8) == (
            ref_estimate_query_cost(ref_q.model, rows, dims, num_groups=8,
                                   platform="cpu"))


def test_serving_backend_keyed_by_device():
    tree = QUERY_IR["P3.tree.year"]().model
    lin = QUERY_IR["P1.linear.year"]().model
    assert TQ.plan_serving_backend(tree, 3, platform="cpu")[0] == "torch"
    for backend in ("fused", "nonfused"):
        choice, why = TQ.plan_serving_backend(tree, 3, backend=backend,
                                              platform="cuda")
        assert choice == "kernel" and "cuda" in why
    assert TQ.plan_serving_backend(lin, 3, backend="nonfused",
                                   platform="cuda")[0] == "torch"
    assert TQ.plan_serving_backend(lin, 9, platform="cuda")[0] == "torch"
    assert TQ.resolve_serve_backend("kernel", "nonfused", lin) == "torch"
    assert TQ.resolve_serve_backend("kernel", "nonfused", tree) == "kernel"
    assert TQ.planner_threshold("DENSE_JOIN_ELEMS", "cuda") == (
        TQ.PLANNER_THRESHOLDS["default"]["DENSE_JOIN_ELEMS"])
    # Above the measured node count "auto" keeps a nonfused tree on torch;
    # an explicit "kernel" request still reaches the kernel.
    cut = TQ.planner_threshold("TREE_KERNEL_MAX_NODES", "cuda")
    assert tree.p <= cut < TQ.SERVE_KERNEL_MAX_NODES
    wide = random_tree(np.random.default_rng(0), 8, 9)
    assert wide.p > cut
    choice, why = TQ.plan_serving_backend(wide, 3, backend="nonfused",
                                          platform="cuda")
    assert choice == "torch" and "measured" in why
    assert TQ.plan_serving_backend(wide, 3, platform="cuda")[0] == "kernel"
    assert TQ.resolve_serve_backend("kernel", "nonfused", wide) == "kernel"


def test_compile_rejects_unported_and_bad_options(tables):
    q = QUERY_IR["P1.linear.year"]()
    with pytest.raises(ValueError, match="serve_backend"):
        TQ.compile_query(tables, q, serve_backend="pallas")
    for opt in ("rewrite", "mesh", "pool", "stream_chunk_rows",
                "chain_strategy", "interpret"):
        with pytest.raises(TypeError):
            TQ.compile_query(tables, q, **{opt: None})


def test_builder_spec_grammar():
    q = (TQ.query("lineorder")
         .join("date", on=("lo_orderdate", "datekey"), features=("d_month",),
               where=[("d_year", "==", 1993)])
         .where(("lo_discount", "between", (1, 3)))
         .group_by(("date", "d_year", 8, 1992), num_groups="auto")
         .agg(rev="sum(lo_revenue)", n="count", m=("mean", "lo_quantity"),
              d=("sub", "lo_revenue", "lo_supplycost"))
         .build())
    assert [(a.value, a.op, a.name) for a in q.aggregates] == [
        ("lo_revenue", "sum", "rev"), ("*", "count", "n"),
        ("lo_quantity", "mean", "m"),
        (("sub", "lo_revenue", "lo_supplycost"), "sum", "d")]
    assert q.group_keys[0] == TQ.GroupKey("date", "d_year", 8, 1992)
    with pytest.raises(ValueError):
        TQ.query("f").agg(x=("nope", "a"))


def test_multi_aggregate_query_matches_reference(tables, ref_cat):
    """count/mean/min/max lower the same way in both packages."""
    def build(mod, model):
        return (mod.query("lineorder")
                .join("part", on=("lo_partkey", "partkey"),
                      features=("p_size", "p_category"))
                .join("date", on=("lo_orderdate", "datekey"),
                      features=("d_month",))
                .predict(model, where=[(0, ">", 0.0)])
                .group_by(("date", "d_year", 8, 1992), num_groups="auto")
                .agg(n="count", mq=("mean", "lo_quantity"),
                     lo=("min", "lo_revenue"), hi=("max", mod.PREDICTION),
                     s="sum(lo_revenue)")
                .build())
    L = np.random.default_rng(4).normal(size=(3, 2)).astype(np.float32)
    want = RQ.compile_query(ref_cat, build(RQ, RefLinear(jnp.asarray(L))),
                            rewrite="off").run()
    got = TQ.compile_query(tables, build(TQ, model_from_arrays("linear",
                                                               L=L))).run()
    assert_run_equal(got, want, exact=False)
