"""Sorting in LAQ (port of ``repro.core.laq.sort``, paper §2.5).

Sorting has no pure LA form.  The paper folds it into MM-Join by sorting
the key domain (key domains are built sorted, so any result keyed on
domain or group position comes out ordered) and otherwise sorts on the
device.  ``order_by`` on arbitrary columns is a chain of stable argsorts
and one gather; padding rows stay last.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .table import Table


def order_by(table: Table, cols: Sequence[str],
             descending: Sequence[bool] | None = None) -> Table:
    """ORDER BY with lexicographic priority of ``cols``; padding stays last."""
    descending = descending or [False] * len(cols)
    valid = table.valid_mask()
    perm = torch.arange(table.capacity, device=table.device)
    # Stable sorts applied from the least to the most significant key.
    for col, desc in reversed(list(zip(cols, descending))):
        vals = table.col(col)[perm]
        if desc:
            vals = -vals
        vals = torch.where(valid[perm], vals, float("inf"))  # padding last
        perm = perm[torch.argsort(vals, stable=True)]
    matrix = table.matrix[perm]
    keys = {c: v[perm] for c, v in table.keys.items()}
    return Table(table.name, table.columns, matrix, keys, table.nvalid)


def sorted_domain_order(values: torch.Tensor) -> torch.Tensor:
    """The paper's 'sort by sorting the key domain': rank of each value
    (int32; ties ranked in input order, as a stable sort ranks them)."""
    order = torch.argsort(values, stable=True)
    ranks = torch.empty_like(order, dtype=torch.int32)
    ranks[order] = torch.arange(order.shape[0], dtype=torch.int32,
                                device=values.device)
    return ranks
