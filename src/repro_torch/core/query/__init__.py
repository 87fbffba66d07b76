"""Predictive-query compiler (port of ``repro.core.query``, in-core slice).

Build a query with the fluent builder, compile it against a mapping of
tables, and run it::

    from repro_torch.core.query import PREDICTION, compile_query, query

    q = (query("lineorder")
         .join("date", on=("lo_orderdate", "datekey"),
               features=("d_month",), where=[("d_year", "==", 1993)])
         .predict(model)
         .agg(pred=("sum", PREDICTION))
         .build())
    plan = compile_query(tables, q)   # runs where the tables live
    plan.run(); plan.predictions(); plan.predict_rows(ids)

Serve FK-tuple requests of any batch size through padding buckets::

    from repro_torch.core.query import compile_serving

    rt = compile_serving(tables, q)   # online phase, compiled once
    rt.serve({"lo_orderdate": keys})  # (n, l) predictions
    rt.latency_stats()                # per-bucket p50/p95/p99, compile_ms

Over a versioned :class:`~repro_torch.core.laq.Catalog`, plans and
runtimes absorb the catalog's mutations in place::

    cat = Catalog(tables)
    plan, rt = compile_query(cat, q), compile_serving(cat, q)
    cat.append("part", rows)          # or update_column / delete_rows
    plan.refresh(); rt.refresh()      # delta when shapes allow, else
                                      # recompile / rebuild; the line says
"""
from ..laq.catalog import (Catalog, CatalogHistoryError,
                           CatalogReadOnlyError, TableDelta)
from .compile import CompiledQuery, compile_query, query_from_star
from .explain import ExplainReport
from .ir import (AGG_OPS, COUNT_STAR, FILTER_OPS, PREDICTION, Aggregate,
                 ArmSpec, GroupKey, PredictionFilter, PredictiveQuery,
                 eval_value)
from .planner import (PLANNER_THRESHOLDS, SERVE_KERNEL_MAX_ARMS,
                      SERVE_KERNEL_MAX_FEATURES, SERVE_KERNEL_MAX_NODES,
                      SERVE_KERNEL_MAX_WIDTH, AggDecision, QueryPlan,
                      effective_serve_backend, estimate_query_cost,
                      plan_aggregation, plan_query, plan_serving_backend,
                      planner_threshold, resolve_serve_backend)
from .serving import (DEFAULT_BUCKETS, LATENCY_WINDOW, SentinelKeyError,
                      ServingRuntime, compile_serving, requests_from_rows)
from .session import QueryBuilder, query

__all__ = [
    "Catalog", "CatalogHistoryError", "CatalogReadOnlyError", "TableDelta",
    "CompiledQuery", "compile_query", "query_from_star", "ExplainReport",
    "AGG_OPS", "COUNT_STAR", "FILTER_OPS", "PREDICTION", "Aggregate", "ArmSpec",
    "GroupKey", "PredictionFilter", "PredictiveQuery", "eval_value",
    "PLANNER_THRESHOLDS",
    "SERVE_KERNEL_MAX_ARMS", "SERVE_KERNEL_MAX_FEATURES",
    "SERVE_KERNEL_MAX_NODES", "SERVE_KERNEL_MAX_WIDTH", "AggDecision",
    "QueryPlan", "effective_serve_backend", "estimate_query_cost",
    "plan_aggregation", "plan_query", "plan_serving_backend",
    "planner_threshold", "resolve_serve_backend", "DEFAULT_BUCKETS",
    "LATENCY_WINDOW", "SentinelKeyError", "ServingRuntime",
    "compile_serving", "requests_from_rows", "QueryBuilder", "query",
]
