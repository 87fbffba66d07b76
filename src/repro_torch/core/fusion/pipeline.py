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
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from ..laq.star import DimSpec, StarJoin, dim_mapping_matrices
from .operators import DecisionTreeGEMM, LinearOperator

Model = Union[LinearOperator, DecisionTreeGEMM]


@dataclasses.dataclass(frozen=True)
class PrefusedStar:
    """Per-dimension pre-fused partials P_j plus the tree's compare vector."""

    partials: Tuple[torch.Tensor, ...]  # each (r_j, l)
    h: Optional[torch.Tensor]           # (l,) for trees, None for linear

    def nbytes(self) -> int:
        return sum(int(p.numel()) * p.element_size() for p in self.partials)


def _feature_slices(dims: Sequence[DimSpec]):
    """[start, stop) of each dimension's block in T's k feature columns."""
    out = []
    off = 0
    for d in dims:
        out.append((off, off + len(d.feature_cols)))
        off += len(d.feature_cols)
    return out


#: Rows of a dimension table per product when partials are computed.  The
#: cold prefuse and the delta refresh cut the table into the same aligned
#: blocks of this many rows and run every product at this one shape, each
#: block copied into a fresh zero-padded buffer: a partial row is then the
#: same computation (same kernel, same position in its block, same
#: alignment) whichever path computes it, so a refreshed partial equals the
#: cold one bit for bit by construction.  A product over just the changed
#: rows would let the BLAS pick another kernel for the other shape, whose
#: rounding differs.
PREFUSE_ROW_BLOCK = 8192


def _arm_fn(dims: Sequence[DimSpec], model: Model, j: int,
            mats: Sequence[torch.Tensor]) -> Callable:
    """Arm ``j``'s partial as a function of a block of its dimension rows:
    ``x (M L)`` (+ the bias on arm 0) for a linear head, ``((x (M F) > v)
    ⊙ W_j) H`` for a tree."""
    m = mats[j]
    if isinstance(model, LinearOperator):
        w = m @ model.L                                      # M L
        bias = (model.bias[None, :] if j == 0 and model.bias is not None
                else None)

        def linear(x):
            part = x @ w
            if bias is not None:
                # The constant term lives in arm 0's partial: a row missing
                # any arm is invalid and zeroed after the sum.
                part = part + bias.to(part.dtype)
            return part
        return linear
    lo, hi = _feature_slices(dims)[j]
    f_owner = torch.argmax(model.F, dim=0)                   # feature per node
    own = ((f_owner >= lo) & (f_owner < hi)).to(torch.float32)
    w = m @ model.F

    def tree(x):
        preds = (x @ w > model.v[None, :]).to(torch.float32) * own[None, :]
        return preds @ model.H                               # (rows, l)
    return tree


def _blocked(matrix: torch.Tensor, fn: Callable,
             blocks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``fn`` over the ``PREFUSE_ROW_BLOCK``-row blocks of ``matrix``.

    ``blocks`` (block numbers) defaults to every block.  The blocks are
    gathered into one fresh zero-padded buffer and ``fn`` runs on each
    block of it in turn; the result is ``(len(blocks)·B, l)``, block after
    block.
    """
    rows_per = PREFUSE_ROW_BLOCK
    r = int(matrix.shape[0])
    if blocks is None:
        nb = -(-r // rows_per)
        x = matrix.new_zeros((nb * rows_per, matrix.shape[1]))
        x[:r] = matrix
    else:
        nb = int(blocks.shape[0])
        idx = (blocks[:, None] * rows_per
               + torch.arange(rows_per, device=matrix.device)).reshape(-1)
        inside = (idx < r)[:, None]
        x = torch.where(inside, matrix[idx.clamp(max=max(r - 1, 0))], 0.0)
    if nb == 0:
        return fn(x)
    return torch.cat([fn(x[b * rows_per:(b + 1) * rows_per])
                      for b in range(nb)])


def prefuse_dims(dims: Sequence[DimSpec], model: Model) -> PrefusedStar:
    """Push the model's linear prefix into dimension tables (Eq. 1/3).

    Operates on bare ``DimSpec``s — no fact table or resolved joins — so
    the serving runtime prefuses once and serves any request batch.  Each
    product is a plain ``torch.matmul`` (fp32, TF32 off) at the fixed block
    shape of ``PREFUSE_ROW_BLOCK`` rows.
    """
    mats = dim_mapping_matrices(dims)
    parts = tuple(
        _blocked(d.dim.matrix, _arm_fn(dims, model, j, mats))[
            :d.dim.capacity]
        for j, d in enumerate(dims))
    return PrefusedStar(parts, model.h if isinstance(model, DecisionTreeGEMM)
                        else None)


def prefuse(star: StarJoin, model: Model) -> PrefusedStar:
    """Push the model's linear prefix into each dimension table (Eq. 1/3)."""
    return prefuse_dims(star.dims, model)


def prefuse_rows(dims: Sequence[DimSpec], model: Model, j: int,
                 row_ids) -> torch.Tensor:
    """Partial rows for dimension ``j`` restricted to ``row_ids``.

    The delta half of incremental prefuse maintenance: Eq. 1/3 partials
    are row-wise in the dimension table, so an append or update dirties
    only the matching partial rows.  The blocks that hold ``row_ids`` are
    recomputed exactly as :func:`prefuse_dims` computes them, and the rows
    taken out, so scattering them back (:func:`extend_prefused`)
    reproduces the cold partial bit for bit.
    """
    mats = dim_mapping_matrices(dims)
    mat = dims[j].dim.matrix
    ids = torch.as_tensor(row_ids).to(device=mat.device,
                                      dtype=torch.int64).reshape(-1)
    blocks, slot = torch.unique(torch.div(ids, PREFUSE_ROW_BLOCK,
                                          rounding_mode="floor"),
                                return_inverse=True)
    out = _blocked(mat, _arm_fn(dims, model, j, mats), blocks)
    return out[slot * PREFUSE_ROW_BLOCK + ids % PREFUSE_ROW_BLOCK]


def extend_prefused(pre: PrefusedStar, dims: Sequence[DimSpec],
                    model: Model,
                    dirty: Sequence[Optional[torch.Tensor]]) -> PrefusedStar:
    """Scatter freshly computed partial rows into copies of the partials.

    ``dirty[j]`` holds the dimension-j row ids to recompute (appended span
    ∪ updated rows), or ``None`` for untouched arms, whose partials are
    reused as they are.  Shapes never change: this is the same-capacity
    delta path; capacity growth goes through a cold ``prefuse``.  The
    partials ``pre`` holds are not written.
    """
    parts = []
    for j, (p, ids) in enumerate(zip(pre.partials, dirty)):
        if ids is None or len(ids) == 0:
            parts.append(p)
            continue
        ids = torch.as_tensor(ids).to(device=p.device, dtype=torch.int64)
        p = p.clone()
        p[ids] = prefuse_rows(dims, model, j, ids)
        parts.append(p)
    return PrefusedStar(tuple(parts), pre.h)


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
