"""The system under test: ``repro_torch``'s tables, query IR and
``compile_query``, fed from the benchmark's generated columns and specs.

This is the one module of the benchmark that imports the program.
"""
from __future__ import annotations

import time
from typing import Dict, Tuple

import torch

from repro_torch.core.fusion import LinearOperator, tree_from_arrays
from repro_torch.core.laq import Catalog, Table
from repro_torch.core.query import (PREDICTION, GroupKey, compile_query,
                                    query)


def tables(host, device) -> Dict[str, Table]:
    """The program's tables, built by its own ``Table.from_columns`` on
    ``device`` from generated columns in host memory (``gen.to_host``), as
    a loader hands them over: what the constructor does with them, its
    layout and its copies, is the program's and counts in set-up."""
    return {name: Table.from_columns(name, rt.columns, key_cols=rt.keys,
                                     device=device)
            for name, rt in host.items()}


def _tup(x):
    return tuple(_tup(v) for v in x) if isinstance(x, list) else x


def model(drawn: dict, k: int):
    """The program's head for drawn parameters."""
    if drawn["kind"] == "linear":
        return LinearOperator(torch.from_numpy(drawn["L"]))
    return tree_from_arrays(drawn["feature"], drawn["threshold"], k)


def build(qspec: dict, drawn=None):
    """The program's ``PredictiveQuery`` for a spec."""
    b = query(qspec["fact"])
    for a in qspec["arms"]:
        b = b.join(a["table"], on=(a["fk"], a["pk"]),
                   features=tuple(a.get("features", ())),
                   where=[_tup(p) for p in a.get("where", ())])
    if qspec["where"]:
        b = b.where(*[_tup(p) for p in qspec["where"]])
    if drawn is not None:
        b = b.predict(model(drawn, sum(len(a.get("features", ()))
                                       for a in qspec["arms"])))
    if qspec["group_by"]:
        b = b.group_by(*[GroupKey(g["table"], g["col"], g["bound"],
                                  g.get("offset", 0))
                         for g in qspec["group_by"]],
                       num_groups=qspec["num_groups"])
    aggs = {}
    for agg in qspec["aggregates"]:
        value = PREDICTION if agg["value"] == "@prediction" else _tup(
            agg["value"])
        aggs[agg["name"]] = (agg["op"], value)
    return b.agg(**aggs).build()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def compile_all(catalog_tables, specs, drawn, device
                ) -> Tuple[Dict[str, object], Dict[str, float]]:
    """A plan per query with the planner's own choices, and the host
    milliseconds of each ``compile_query`` (ending in a synchronize)."""
    cat = Catalog(catalog_tables)
    plans, ms = {}, {}
    for name, qspec in specs.items():
        q = build(qspec, drawn.get(name))
        t = time.perf_counter()
        plans[name] = compile_query(cat, q)
        sync(device)
        ms[name] = (time.perf_counter() - t) * 1e3
    return plans, ms


def describe(plan) -> dict:
    """The plan's choices, from ``explain()``."""
    rep = plan.explain()
    return {"backend": rep.backend, "join": rep.join_backend,
            "agg": rep.agg_backend, "serve": rep.serve_backend,
            "explain": str(rep)}


def build_kernels(device: torch.device) -> None:
    """Build (first run of a checkout) or load the program's kernels."""
    if device.type == "cuda":
        from repro_torch.kernels import _build
        _build.load()


def launches() -> Dict[str, int]:
    """The kernels' own launch counters."""
    from repro_torch.kernels.fused_star_gather import fused_star_gather
    from repro_torch.kernels.onehot_matmul import onehot_matmul
    from repro_torch.kernels.tree_predict import tree_predict
    return {"fused_star_gather": fused_star_gather.launches,
            "tree_predict": tree_predict.launches,
            "onehot_matmul": onehot_matmul.launches}
