"""Selection as a binary filter vector (port of ``repro.core.laq.selection``).

Predicates are ``(col, op, literal)`` terms combined with AND/OR; key columns
compare exactly in int32.  ``select`` is the paper's ``mask_select``: compact
the surviving rows into a fixed-capacity buffer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from .table import PAD_KEY, Table

_OPS = {
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


@dataclasses.dataclass(frozen=True)
class Pred:
    """A single predicate term ``col <op> value`` (or ``col BETWEEN lo, hi``)."""

    col: str
    op: str  # one of _OPS | "between" | "in"
    value: object

    def mask(self, table: Table) -> torch.Tensor:
        col = (table.key(self.col) if self.col in table.keys
               else table.col(self.col))
        if self.op == "between":
            lo, hi = self.value
            m = (col >= lo) & (col <= hi)
        elif self.op == "in":
            vals = torch.tensor(list(self.value), dtype=col.dtype,
                                device=col.device)
            m = torch.isin(col, vals)
        else:
            m = _OPS[self.op](col, torch.tensor(self.value, dtype=col.dtype,
                                                device=col.device))
        return m & table.valid_mask()


def selection_vector(table: Table, preds: Sequence[Pred],
                     combine: str = "and") -> torch.Tensor:
    """The paper's binary filter vector (float {0,1}) over rows."""
    if not preds:
        return table.valid_mask().to(torch.float32)
    out = preds[0].mask(table)
    for p in preds[1:]:
        m = p.mask(table)
        out = (out & m) if combine == "and" else (out | m)
    return out.to(torch.float32)


def select(table: Table, preds: Sequence[Pred],
           capacity: Optional[int] = None, combine: str = "and") -> Table:
    """mask_select: compact rows passing ``preds`` into a capacity buffer.

    As in the reference, ``nvalid`` counts every surviving row even when
    more survive than ``capacity`` holds.
    """
    cap = capacity if capacity is not None else table.capacity
    mask = selection_vector(table, preds, combine).to(torch.bool)
    idx = torch.nonzero(mask).squeeze(1)[:cap]
    m = int(idx.shape[0])
    matrix = torch.zeros((cap, table.ncols), dtype=table.matrix.dtype,
                         device=table.device)
    matrix[:m] = table.matrix[idx]
    keys = {}
    for c, v in table.keys.items():
        k = torch.full((cap,), PAD_KEY, dtype=v.dtype, device=v.device)
        k[:m] = v[idx]
        keys[c] = k
    return Table(table.name, table.columns, matrix, keys, int(mask.sum()))
