"""Star join (paper §3.1), port of ``repro.core.laq.star``.

``T = I₁BM₁ + I₂CM₂ + I₃DM₃`` — each dimension contributes its projected
columns to a disjoint slice of T, selected by a factored matching matrix.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from .join import FactoredJoin, join_factored
from .projection import mapping_matrix
from .table import Table


@dataclasses.dataclass(frozen=True)
class DimSpec:
    """One arm of the star: fact.fk_col joins dim.pk_col, keep feature_cols."""

    dim: Table
    fk_col: str
    pk_col: str
    feature_cols: tuple


@dataclasses.dataclass(frozen=True)
class StarJoin:
    """Resolved star join: factored matching matrices + combined validity."""

    fact: Table
    dims: Tuple[DimSpec, ...]
    joins: Tuple[FactoredJoin, ...]
    row_valid: torch.Tensor  # fact rows with matches in *all* dimensions

    @property
    def feature_width(self) -> int:
        return sum(len(d.feature_cols) for d in self.dims)

    def mapping_matrices(self) -> Tuple[torch.Tensor, ...]:
        return dim_mapping_matrices(self.dims)

    def materialize(self) -> torch.Tensor:
        """T = Σⱼ Iⱼ (Bⱼ Mⱼ) via gathers — (fact_capacity, k) float32."""
        parts = []
        for d, fj in zip(self.dims, self.joins):
            proj = d.dim.matrix @ mapping_matrix(
                d.dim.columns, d.feature_cols, device=d.dim.device)
            parts.append(fj.apply(proj))
        t = torch.cat(parts, dim=1)
        return t * self.row_valid[:, None].to(t.dtype)

    def materialize_matmul(self) -> torch.Tensor:
        """Paper-faithful: dense Iⱼ one-hot matmuls (small inputs only)."""
        out = torch.zeros((self.fact.capacity, self.feature_width),
                          dtype=torch.float32, device=self.fact.device)
        for d, fj, m in zip(self.dims, self.joins, self.mapping_matrices()):
            out = out + fj.dense(d.dim.capacity) @ (d.dim.matrix @ m)
        return out * self.row_valid[:, None]


def dim_mapping_matrices(dims: Sequence[DimSpec]) -> Tuple[torch.Tensor, ...]:
    """M_j for a sequence of arms, independent of any fact table."""
    k = sum(len(d.feature_cols) for d in dims)
    mats = []
    offset = 0
    for d in dims:
        m = torch.zeros((d.dim.ncols, k), dtype=torch.float32,
                        device=d.dim.device)
        for t, col in enumerate(d.feature_cols):
            m[d.dim.col_index(col), offset + t] = 1.0
        mats.append(m)
        offset += len(d.feature_cols)
    return tuple(mats)


def star_join(fact: Table, dims: Sequence[DimSpec]) -> StarJoin:
    """Resolve FK pointers for every dimension arm (multi-way join, §2.3.2)."""
    joins = []
    valid = fact.valid_mask()
    for d in dims:
        fj = join_factored(fact.key(d.fk_col), d.dim.key(d.pk_col))
        joins.append(fj)
        valid = valid & fj.found
    return StarJoin(fact=fact, dims=tuple(dims), joins=tuple(joins),
                    row_valid=valid)
