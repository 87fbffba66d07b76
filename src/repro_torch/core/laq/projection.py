"""Projection as matrix multiplication (port of ``repro.core.laq.projection``).

``π_{cols}(S) = S · M`` with the column-mapping matrix ``M ∈ {0,1}^{c×k}``.

* ``project_matmul`` — the paper-faithful LA form, one matmul.
* ``project_gather`` — the same projection as a column gather (no FLOPs).
"""
from __future__ import annotations

from typing import Sequence

import torch

from .table import Table


def mapping_matrix(source_cols: Sequence[str], target_cols: Sequence[str],
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """Build M ∈ {0,1}^{c×k} mapping source columns to target columns."""
    m = torch.zeros((len(source_cols), len(target_cols)), dtype=dtype,
                    device=device)
    src = list(source_cols)
    for j, name in enumerate(target_cols):
        m[src.index(name), j] = 1
    return m


def project_matmul(table: Table, target_cols: Sequence[str]) -> Table:
    """Paper-faithful projection: one (r×c)·(c×k) matmul."""
    m = mapping_matrix(table.columns, target_cols, table.matrix.dtype,
                       table.device)
    keys = {c: v for c, v in table.keys.items() if c in target_cols}
    return Table(table.name, tuple(target_cols), table.matrix @ m, keys,
                 table.nvalid)


def project_gather(table: Table, target_cols: Sequence[str]) -> Table:
    """Optimized projection: column gather (no FLOPs)."""
    idx = torch.tensor([table.col_index(c) for c in target_cols],
                       dtype=torch.int64, device=table.device)
    keys = {c: v for c, v in table.keys.items() if c in target_cols}
    return Table(table.name, tuple(target_cols),
                 table.matrix.index_select(1, idx), keys, table.nvalid)
