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
"""
from .compile import CompiledQuery, compile_query
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
from .session import QueryBuilder, query

__all__ = [
    "CompiledQuery", "compile_query", "ExplainReport", "AGG_OPS",
    "COUNT_STAR", "FILTER_OPS", "PREDICTION", "Aggregate", "ArmSpec",
    "GroupKey", "PredictionFilter", "PredictiveQuery", "eval_value",
    "PLANNER_THRESHOLDS",
    "SERVE_KERNEL_MAX_ARMS", "SERVE_KERNEL_MAX_FEATURES",
    "SERVE_KERNEL_MAX_NODES", "SERVE_KERNEL_MAX_WIDTH", "AggDecision",
    "QueryPlan", "effective_serve_backend", "estimate_query_cost",
    "plan_aggregation", "plan_query", "plan_serving_backend",
    "planner_threshold", "resolve_serve_backend", "QueryBuilder", "query",
]
