"""Predictive-query compiler (port of ``repro.core.query``).

A :class:`Session` binds a catalog (and optionally a device mesh) once;
its fluent builder describes the pipeline and drives every execution
mode::

    from repro_torch.core.query import PREDICTION, Session

    sess = Session(catalog)
    q = (sess.query("lineorder")
         .join("date", on=("lo_orderdate", "datekey"),
               features=["d_month"], where=[("d_year", "==", 1993)])
         .predict(model)
         .agg(pred=("sum", PREDICTION)))
    q.run(); q.rows(row_ids); q.serve(buckets=(8, 64))
    sess.run_all([q1, q2, ...])   # compatible plans run as one class
    sess.pool.stats()             # the shared artifacts the plans hold
    sess.scheduler()              # async admission over serving runtimes

Every plan and runtime a session compiles takes its PK indices, join
columns, predicate masks and prefused partials from the session's
:class:`ArtifactPool`; a catalog mutation refreshes each shared artifact
once.

Migration from the pre-Session entry points (still working, with a
``DeprecationWarning`` for a plain mapping or ``compiled_plan``):

=============================================  =============================
Old call                                       Session call
=============================================  =============================
``compile_query(catalog, q, **kw)``            ``sess.compile(q, **kw)`` or
                                               ``sess.bind(q).compile(**kw)``
``compile_query(catalog, q).run()``            ``sess.bind(q).run()``
``[compile_query(c, q).run() for q in qs]``    ``sess.run_all(qs)``
``CompiledQuery.predict_rows(ids)``            ``builder.rows(ids)``
``compile_serving(catalog, q, buckets=b)``     ``builder.serve(buckets=b)``
``compiled_plan(name, data)``                  ``ssb_session(data).compile(
                                               QUERY_IR[name]())``
=============================================  =============================

The entry points under the session — build a query with the fluent
builder, compile it against a mapping of tables, and run it::

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

Stream the fact axis out of core (``run()`` folds it chunk by chunk;
dimension-side artifacts stay on the device)::

    plan = compile_query(cat, q, stream_chunk_rows=1 << 20)
    plan = compile_query(cat, q, memory_budget_bytes=2 << 30)  # if needed
    Session(cat, memory_budget_bytes=2 << 30)                  # every plan

Shard the serving state over a mesh of devices (partials row-sharded over
``"model"``, request batches split over ``"data"``; equal to the
single-device plain path)::

    from repro_torch.launch.mesh import make_serving_mesh

    mesh = make_serving_mesh((2, 4))                  # one card a position
    mesh = make_serving_mesh((2, 4), device="cuda:0")  # or all on one card
    rt = compile_serving(cat, q, mesh=mesh)
    plan = compile_query(cat, q, mesh=mesh)           # sharded predict_rows
    Session(cat, mesh=mesh)                           # every plan/runtime
"""
from ..laq.catalog import (Catalog, CatalogHistoryError,
                           CatalogReadOnlyError, TableDelta, changed_spans)
from .compile import CompiledQuery, compile_query, query_from_star
from .explain import ExplainReport
from .ir import (AGG_OPS, COUNT_STAR, FILTER_OPS, PREDICTION, Aggregate,
                 ArmSpec, ChainLink, GroupKey, PredictionFilter,
                 PredictiveQuery, eval_value, query_signature)
from .rewrite import RewriteResult, rewrite_query
from .snowflake import (CollapsedChain, chain_tables, materialize_chains,
                        resolve_chain, virtual_name)
from .multiquery import (ArtifactPool, arm_keys, artifact_bytes,
                         make_stacked_runner, stack_key, stack_states)
from .planner import (DENSE_JOIN_ELEMS, MXU_SEGMENT_ADVANTAGE,
                      PLANNER_THRESHOLDS, SERVE_KERNEL_MAX_ARMS,
                      SERVE_KERNEL_MAX_FEATURES, SERVE_KERNEL_MAX_NODES,
                      SERVE_KERNEL_MAX_WIDTH, AggDecision, QueryPlan,
                      effective_serve_backend, estimate_query_cost,
                      SHARD_PARTIAL_BYTES, plan_aggregation,
                      plan_chain_materialization, plan_partition_spec,
                      plan_placements, plan_query, plan_serving_backend,
                      plan_streaming, planner_threshold,
                      resolve_serve_backend)
from .serving import (DEFAULT_BUCKETS, LATENCY_WINDOW, SentinelKeyError,
                      ServingRuntime, compile_serving, requests_from_rows)
from .scheduler import (DEFAULT_MAX_QUEUED_ROWS, DEFAULT_SLO_MS, LANES,
                        AdmissionScheduler, ScheduledPlan,
                        SchedulerBackpressureError, SchedulerClosedError)
from .session import QueryBuilder, Session, query, query_key
from .streaming import DEFAULT_CHUNK_ROWS, StreamExecutor, plan_chunk_rows
from .workload import FuzzCase, FuzzReport, generate_case, np_oracle, run_fuzz
from .sharding import (ShardedArm, ShardedPrefusedPartials,
                       shard_prefused_partials)

__all__ = [
    "Catalog", "CatalogHistoryError", "CatalogReadOnlyError", "TableDelta",
    "changed_spans", "CompiledQuery", "compile_query", "query_from_star", "ExplainReport",
    "AGG_OPS", "COUNT_STAR", "FILTER_OPS", "PREDICTION", "Aggregate", "ArmSpec",
    "ChainLink", "GroupKey", "PredictionFilter", "PredictiveQuery",
    "eval_value", "query_signature", "RewriteResult", "rewrite_query",
    "CollapsedChain", "chain_tables", "materialize_chains", "resolve_chain",
    "virtual_name", "FuzzCase", "FuzzReport", "generate_case", "np_oracle",
    "run_fuzz", "ArtifactPool", "arm_keys", "artifact_bytes",
    "make_stacked_runner", "stack_key", "stack_states",
    "PLANNER_THRESHOLDS", "DENSE_JOIN_ELEMS", "MXU_SEGMENT_ADVANTAGE",
    "SERVE_KERNEL_MAX_ARMS", "SERVE_KERNEL_MAX_FEATURES",
    "SERVE_KERNEL_MAX_NODES", "SERVE_KERNEL_MAX_WIDTH", "AggDecision",
    "QueryPlan", "effective_serve_backend", "estimate_query_cost",
    "plan_aggregation", "plan_chain_materialization", "plan_query",
    "plan_serving_backend", "plan_streaming", "DEFAULT_CHUNK_ROWS",
    "StreamExecutor", "plan_chunk_rows",
    "planner_threshold", "resolve_serve_backend", "DEFAULT_BUCKETS",
    "LATENCY_WINDOW", "SentinelKeyError", "ServingRuntime",
    "compile_serving", "requests_from_rows",
    "AdmissionScheduler", "ScheduledPlan", "SchedulerBackpressureError",
    "SchedulerClosedError", "DEFAULT_MAX_QUEUED_ROWS", "DEFAULT_SLO_MS",
    "LANES", "QueryBuilder", "Session", "query", "query_key",
    "SHARD_PARTIAL_BYTES", "plan_partition_spec", "plan_placements",
    "ShardedArm", "ShardedPrefusedPartials", "shard_prefused_partials",
]
