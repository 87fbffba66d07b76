"""Whole-query cost model: fusion × join backend × aggregation backend ×
serving kernel (port of ``repro.core.query.planner``, single device).

Thresholds are keyed by torch device type.  The ``"default"`` row is
CPU-seeded; the ``"cuda"`` row holds only what was measured on the card, and
every other threshold of a CUDA plan reads the default row.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from ...kernels.fused_star_gather.ops import MAX_ARMS
from ..fusion.operators import DecisionTreeGEMM
from ..fusion.planner import FusionDecision, plan_fusion
from .ir import Model

PLANNER_THRESHOLDS = {
    "default": {
        # Dense one-hot row-matching matrices only when (fact × dim) is
        # small (paper §4.2: MM-Join loses to pointer joins at scale).
        "DENSE_JOIN_ELEMS": 1 << 14,
        # One-hot matmul aggregation is picked while its FLOP overcount
        # (≈2·G) stays under this advantage over a scatter segment-sum.
        "MXU_SEGMENT_ADVANTAGE": 16.0,
        # Largest tree (internal nodes) that "auto" serves on tree_predict.
        "TREE_KERNEL_MAX_NODES": 16384,
    },
    "cuda": {
        # tree_predict against the plain torch version on an H100 80GB HBM3
        # at 700 W (scripts/torch_tree_predict_times.py): 7.7x faster at
        # p=7, on par at p=127, 1.8x slower at p=511.
        "TREE_KERNEL_MAX_NODES": 127,
    },
}

# Kernel bounds.  fused_star_gather takes at most 8 arms (its by-value
# partial table); tree_predict stages at least 4 rows of x (4·k floats) plus
# their predicates (8·p bytes) in one block's shared memory, which these
# bounds keep under Hopper's 227 KiB.
SERVE_KERNEL_MAX_WIDTH = 8192
SERVE_KERNEL_MAX_NODES = 16384
SERVE_KERNEL_MAX_FEATURES = 1024
SERVE_KERNEL_MAX_ARMS = MAX_ARMS

SERVE_BACKENDS = ("auto", "torch", "kernel")


def planner_threshold(name: str, platform: Optional[str] = None):
    """The calibrated threshold ``name`` for torch device type ``platform``.

    Platforms without a calibration row read the ``"default"`` row.
    """
    defaults = PLANNER_THRESHOLDS["default"]
    if name not in defaults:
        raise KeyError(f"unknown planner threshold {name!r}; expected one "
                       f"of {sorted(defaults)}")
    return PLANNER_THRESHOLDS.get(platform, defaults).get(name, defaults[name])


@dataclasses.dataclass(frozen=True)
class AggDecision:
    backend: str            # "segment" | "matmul"
    matmul_flops: float
    segment_flops: float
    reason: str


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    backend: str            # "fused" | "nonfused"
    join_backend: str       # "gather" | "matmul"
    agg: Optional[AggDecision]
    fusion: Optional[FusionDecision]
    selectivity: float
    reason: str
    serve_backend: str = "torch"   # "torch" | "kernel"


def plan_serving_backend(model: Optional[Model], num_arms: int, *,
                         backend: str = "fused",
                         platform: str) -> Tuple[str, str]:
    """Physical backend of the online step: hand-written kernel or torch.

    Returns ``(backend, reason)``.  On ``cuda`` the kernel is the default
    whenever the shapes fit its bounds and, for a nonfused tree, the tree is
    no larger than ``TREE_KERNEL_MAX_NODES``; on ``cpu`` there is no kernel
    to run, so it is ``"torch"``.
    """
    if model is None:
        return "torch", "no model head: nothing to lower onto a kernel"
    if platform != "cuda":
        return "torch", f"device {platform!r}: the CUDA kernels need a card"
    if backend == "fused":
        if not 1 <= num_arms <= SERVE_KERNEL_MAX_ARMS:
            return "torch", (f"J={num_arms} arms outside fused_star_gather's "
                             f"1..{SERVE_KERNEL_MAX_ARMS}")
        if model.l > SERVE_KERNEL_MAX_WIDTH:
            return "torch", (f"l={model.l} exceeds fused_star_gather width "
                             f"bound {SERVE_KERNEL_MAX_WIDTH}")
        return "kernel", (f"cuda: fused_star_gather fits (J={num_arms}, "
                          f"l={model.l})")
    if isinstance(model, DecisionTreeGEMM):
        if not (model.p <= SERVE_KERNEL_MAX_NODES
                and model.l <= SERVE_KERNEL_MAX_WIDTH
                and model.k <= SERVE_KERNEL_MAX_FEATURES):
            return "torch", (f"tree k={model.k}/p={model.p}/l={model.l} "
                             "exceeds tree_predict's bounds")
        max_nodes = planner_threshold("TREE_KERNEL_MAX_NODES", platform)
        if model.p > max_nodes:
            return "torch", (f"cuda: tree p={model.p} above {max_nodes} "
                             "nodes, where tree_predict measured slower "
                             "than torch")
        return "kernel", (f"cuda: tree_predict fits (k={model.k}, "
                          f"p={model.p}, l={model.l})")
    return "torch", "nonfused linear head: no kernel, torch.matmul"


def resolve_serve_backend(serve_backend: str, backend: str, model) -> str:
    """Clamp a requested serve backend to one that has a kernel.

    A non-fused linear head has no kernel (its online step is a plain
    matmul), so a "kernel" request becomes "torch" there.
    """
    if serve_backend != "kernel" or backend == "fused":
        return serve_backend
    return "kernel" if isinstance(model, DecisionTreeGEMM) else "torch"


def effective_serve_backend(plan: QueryPlan, serve_backend: str,
                            backend: str, model, num_arms: int, *,
                            platform: str) -> str:
    """The serve backend that will actually execute.

    "auto" is re-planned against the resolved execution backend; explicit
    choices are clamped only where no kernel exists.
    """
    if serve_backend == "auto":
        if backend == plan.backend:
            return plan.serve_backend
        return plan_serving_backend(model, num_arms, backend=backend,
                                    platform=platform)[0]
    return resolve_serve_backend(serve_backend, backend, model)


def plan_aggregation(online_rows: float, num_groups: int, out_width: int,
                     ops: Sequence[str] = ("sum",),
                     platform: Optional[str] = None) -> AggDecision:
    """Fig. 4 matmul vs segment-sum, costed over the whole aggregate set."""
    i = max(online_rows, 1.0)
    g = max(num_groups, 1)
    l = max(out_width, 1)
    ops = tuple(ops) or ("sum",)
    n_sums = sum(1 for op in ops if op in ("sum", "mean"))
    needs_count = any(op in ("count", "mean") for op in ops)
    n_minmax = sum(1 for op in ops if op in ("min", "max"))
    matmul = 2.0 * i * g * l * n_sums + (2.0 * i * g if needs_count else 0.0)
    segment = (i * l + i) * n_sums + (2.0 * i if needs_count else 0.0)
    shared = (i * l + i) * n_minmax
    advantage = planner_threshold("MXU_SEGMENT_ADVANTAGE", platform)
    if matmul > 0 and matmul <= segment * advantage:
        return AggDecision("matmul", matmul + shared, segment + shared,
                           f"G={g} small: one-hot matmul beats scatter")
    return AggDecision("segment", matmul + shared, segment + shared,
                       f"G={g}: segment ops ({segment + shared:.0f} flops) "
                       f"beat one-hot matmul ({matmul + shared:.0f} flops)")


def estimate_query_cost(model: Optional[Model], fact_rows: int,
                        dim_rows: Sequence[int], *, num_groups: int = 0,
                        out_width: int = 1, agg_ops: Sequence[str] = ("sum",),
                        batches_per_update: float = 1000.0,
                        platform: Optional[str] = None) -> float:
    """Scalar per-batch work estimate (online phase + amortized prefuse)."""
    n = float(max(fact_rows, 1))
    j = max(len(dim_rows), 1)
    r = float(sum(dim_rows)) if dim_rows else 0.0
    cost = 2.0 * n * j
    if model is not None:
        l = max(model.l, 1)
        cost += n * (j + 1) * l
        offline = 2.0 * r * max(model.k, 1) * l
        if isinstance(model, DecisionTreeGEMM):
            offline += r * model.p * (l + 2.0)
            cost += n * l
        cost += offline / max(batches_per_update, 1.0)
    if num_groups > 0:
        agg = plan_aggregation(n, num_groups, out_width, ops=agg_ops,
                               platform=platform)
        cost += min(agg.matmul_flops, agg.segment_flops)
    return cost


def plan_query(model: Optional[Model], fact_rows: int,
               dim_rows: Sequence[int], *, platform: str,
               selectivity: float = 1.0, num_groups: int = 0,
               out_width: int = 1, agg_ops: Sequence[str] = ("sum",),
               batches_per_update: float = 1000.0) -> QueryPlan:
    """Pick fused/nonfused + join/agg/serving backends for one query on
    torch device type ``platform``."""
    sel = min(max(float(selectivity), 0.0), 1.0)
    online_rows = float(fact_rows) * sel

    fusion = None
    backend = "fused"
    if model is not None:
        fusion = plan_fusion(model, fact_rows, dim_rows,
                             batches_per_update=batches_per_update,
                             selectivity=sel)
        backend = "fused" if fusion.fuse else "nonfused"

    dense_elems = float(fact_rows) * float(max(dim_rows, default=1))
    join_backend = ("matmul" if dense_elems <= planner_threshold(
        "DENSE_JOIN_ELEMS", platform) else "gather")

    agg = None
    if num_groups > 0:
        agg = plan_aggregation(online_rows, num_groups, out_width,
                               ops=agg_ops, platform=platform)

    serve_backend, serve_reason = plan_serving_backend(
        model, len(dim_rows), backend=backend, platform=platform)

    parts = [f"sel={sel:.3f}", f"join={join_backend}"]
    if fusion is not None:
        parts.append(f"{backend} ({fusion.reason})")
    if agg is not None:
        parts.append(f"agg={agg.backend}")
    parts.append(f"serve={serve_backend} ({serve_reason})")
    return QueryPlan(backend=backend, join_backend=join_backend, agg=agg,
                     fusion=fusion, selectivity=sel,
                     reason="; ".join(parts), serve_backend=serve_backend)
