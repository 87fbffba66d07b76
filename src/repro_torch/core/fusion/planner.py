"""Cost-based fusion planner — the paper's Eq. 2 / Eq. 4 decision boundary
(port of ``repro.core.fusion.planner``; pure Python, no tensors)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

from .operators import DecisionTreeGEMM, LinearOperator

Model = Union[LinearOperator, DecisionTreeGEMM]


@dataclasses.dataclass(frozen=True)
class FusionDecision:
    fuse: bool
    est_speedup: float          # Eq. 2 / Eq. 4 ratio (steady state)
    amortized_speedup: float    # including pre-fusion amortization
    prefused_bytes: int
    reason: str


def _flops_linear(i: float, k: float, l: float, rows: Sequence[int]):
    sr = float(sum(rows))
    non = (i * k + k * k / 3.0) * sr + i * k * l
    fus = i * l * sr
    pre = sum(r * k * l for r in rows)
    return non, fus, pre


def _flops_tree(i: float, k: float, p: float, l: float, rows: Sequence[int]):
    sr = float(sum(rows))
    non = (k * k / 3.0 + i * k) * sr + i * k * p + i * p + i * p * l + i * l
    fus = i * l * sr + i * l
    pre = sum(r * (k * p + p + p * l) for r in rows)
    return non, fus, pre


def plan_fusion(model: Model, fact_rows: int, dim_rows: Sequence[int],
                batches_per_update: float = 1000.0,
                memory_budget_bytes: Optional[int] = None,
                selectivity: float = 1.0) -> FusionDecision:
    """Fused-vs-nonfused decision for one predictive query."""
    i = float(fact_rows) * min(max(float(selectivity), 0.0), 1.0)
    k = float(model.k)
    l = float(model.l)
    if isinstance(model, LinearOperator):
        non, fus, pre = _flops_linear(i, k, l, dim_rows)
    else:
        non, fus, pre = _flops_tree(i, k, float(model.p), l, dim_rows)

    est = non / max(fus, 1.0)
    amort = non / max(fus + pre / max(batches_per_update, 1e-9), 1.0)
    prefused_bytes = int(sum(r * l for r in dim_rows)) * 4

    if memory_budget_bytes is not None and prefused_bytes > memory_budget_bytes:
        return FusionDecision(False, est, amort, prefused_bytes,
                              f"prefused partials {prefused_bytes}B exceed "
                              f"budget {memory_budget_bytes}B")
    if amort <= 1.0:
        return FusionDecision(False, est, amort, prefused_bytes,
                              "pre-fusion cost not amortized at this update "
                              f"rate (amortized speedup {amort:.2f}x)")
    return FusionDecision(True, est, amort, prefused_bytes,
                          f"k/l = {k / l:.1f}; est {est:.1f}x, "
                          f"amortized {amort:.1f}x")
