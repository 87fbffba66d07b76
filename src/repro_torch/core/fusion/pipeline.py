"""Operator fusion of ML predictions into star-join query processing (§3),
port of ``repro.core.fusion.pipeline``.

  linear (Eq. 1):   T·L = I₁(B M₁ L) + I₂(C M₂ L) + I₃(D M₃ L)
  tree   (Eq. 3):   ((T F > v) H) == h
                  = (I₁((B M₁ F > v)⊙W₁)H + I₂(...) + I₃(...)) == h

``prefuse`` computes the per-dimension partials once; ``predict_fused`` then
does |dims| gathers + adds (+ one compare for trees) per batch.  ``W_j`` masks
the tree nodes whose feature lives outside dimension j, so the partial sums
are exact.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch

from ..laq.star import DimSpec, StarJoin, dim_mapping_matrices
from .operators import DecisionTreeGEMM, LinearOperator

Model = Union[LinearOperator, DecisionTreeGEMM]


@dataclasses.dataclass(frozen=True)
class PrefusedStar:
    """Per-dimension pre-fused partials P_j plus the tree's compare vector."""

    partials: Tuple[torch.Tensor, ...]  # each (r_j, l)
    h: Optional[torch.Tensor]           # (l,) for trees, None for linear


def _feature_slices(dims: Sequence[DimSpec]):
    """[start, stop) of each dimension's block in T's k feature columns."""
    out = []
    off = 0
    for d in dims:
        out.append((off, off + len(d.feature_cols)))
        off += len(d.feature_cols)
    return out


def prefuse_dims(dims: Sequence[DimSpec], model: Model) -> PrefusedStar:
    """Push the model's linear prefix into dimension tables (Eq. 1/3).

    ``B (M L)`` stays a plain ``torch.matmul`` (fp32, TF32 off): a large
    dense product outside any kernel, as the reference leaves it to XLA.
    """
    mats = dim_mapping_matrices(dims)
    parts = []
    if isinstance(model, LinearOperator):
        for j, (d, m) in enumerate(zip(dims, mats)):
            part = d.dim.matrix @ (m @ model.L)              # B M L
            if j == 0 and model.bias is not None:
                # The constant term lives in arm 0's partial: a row missing
                # any arm is invalid and zeroed after the sum.
                part = part + model.bias[None, :].to(part.dtype)
            parts.append(part)
        return PrefusedStar(tuple(parts), None)
    slices = _feature_slices(dims)
    f_owner = torch.argmax(model.F, dim=0)                   # feature per node
    for d, m, (lo, hi) in zip(dims, mats, slices):
        own = ((f_owner >= lo) & (f_owner < hi)).to(torch.float32)
        feats = d.dim.matrix @ (m @ model.F)                 # (r_j, p)
        preds = (feats > model.v[None, :]).to(torch.float32) * own[None, :]
        parts.append(preds @ model.H)                        # (r_j, l)
    return PrefusedStar(tuple(parts), model.h)


def prefuse(star: StarJoin, model: Model) -> PrefusedStar:
    """Push the model's linear prefix into each dimension table (Eq. 1/3)."""
    return prefuse_dims(star.dims, model)


def predict_fused(star: StarJoin, pre: PrefusedStar) -> torch.Tensor:
    """Online phase: Σⱼ Iⱼ Pⱼ (gathers) and, for trees, `== h`."""
    acc = None
    for fj, p in zip(star.joins, pre.partials):
        part = fj.apply(p)
        acc = part if acc is None else acc + part
    valid = star.row_valid[:, None].to(acc.dtype)
    acc = acc * valid
    if pre.h is None:
        return acc
    return (acc == pre.h[None, :].to(acc.dtype)).to(acc.dtype) * valid


def predict_fused_matmul(star: StarJoin, pre: PrefusedStar) -> torch.Tensor:
    """Paper-faithful online phase: dense Iⱼ matmuls (small inputs only)."""
    acc = None
    for d, fj, p in zip(star.dims, star.joins, pre.partials):
        part = fj.dense(d.dim.capacity) @ p
        acc = part if acc is None else acc + part
    valid = star.row_valid[:, None].to(acc.dtype)
    acc = acc * valid
    if pre.h is None:
        return acc
    return (acc == pre.h[None, :]).to(acc.dtype) * valid


def predict_nonfused(star: StarJoin, model: Model) -> torch.Tensor:
    """Baseline: materialize T, then run the model (separate execution)."""
    out = model.apply(star.materialize())
    return out * star.row_valid[:, None].to(out.dtype)


def predict_nonfused_matmul(star: StarJoin, model: Model) -> torch.Tensor:
    """Paper-faithful baseline: dense-I materialization, then the model."""
    out = model.apply(star.materialize_matmul())
    return out * star.row_valid[:, None].to(out.dtype)


def predict_fused_kernel(star: StarJoin, pre: PrefusedStar, *,
                         ptrs: torch.Tensor, founds: torch.Tensor
                         ) -> torch.Tensor:
    """Online phase on the ``fused_star_gather`` kernel.

    Same contraction as :func:`predict_fused`, in one pass: the per-arm
    liveness is applied inside the kernel and the combined row validity
    after the compare, which matches :func:`predict_fused` bit for bit
    (identical fp32 add order).  ``ptrs``/``founds`` are the ``(J, n)``
    stacked joins (:func:`~repro_torch.core.laq.join.stack_joins`), made
    once by the caller.
    """
    from ...kernels.fused_star_gather import fused_star_gather

    out = fused_star_gather(ptrs, founds, list(pre.partials), pre.h)
    return out * star.row_valid[:, None].to(out.dtype)


def predict_nonfused_kernel(star: StarJoin, model: DecisionTreeGEMM
                            ) -> torch.Tensor:
    """Baseline with the tree head on the ``tree_predict`` kernel.

    Only decision trees have a kernel on the non-fused path; callers gate on
    the model type — linear heads stay on ``torch.matmul``.
    """
    from ...kernels.tree_predict import tree_predict

    out = tree_predict(star.materialize(), model.F, model.v, model.H,
                       model.h)
    return out * star.row_valid[:, None].to(out.dtype)
