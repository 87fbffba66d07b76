"""Group-by aggregation in LAQ (port of ``repro.core.laq.aggregation``).

* ``composite_code`` — multi-column group keys as one int32 code.
* ``groupby_codes`` — codes → (sorted unique codes, dense group ids), on the
  host in numpy exactly as the reference's concrete path does.
* ``segment_aggregate`` / ``segment_reduce`` — per-group reductions into
  ``G+1`` slots (the last one collects padding and is dropped).
* ``matmul_aggregate`` — the paper's Fig. 4 one-hot matmul.

Rows whose group id is the overflow slot ``num_groups`` drop out of every
aggregate.  ``index_add_`` on CUDA adds with atomics, so float sums there
are not bit-reproducible from run to run; integer-valued data sums exactly.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

PAD_GROUP = 2**31 - 1


def composite_code(cols: Sequence[torch.Tensor], bounds: Sequence[int],
                   valid: torch.Tensor) -> torch.Tensor:
    """Encode multi-column group keys into one int32 code (row-major)."""
    total = 1
    for b in bounds:
        total *= int(b)
    if total >= 2**31:
        raise ValueError(f"composite code space {total} overflows int32")
    code = torch.zeros_like(cols[0], dtype=torch.int32)
    for c, b in zip(cols, bounds):
        code = code * int(b) + c.to(torch.int32)
    return torch.where(valid, code, torch.full_like(code, PAD_GROUP))


def _unique_codes(codes: torch.Tensor) -> Tuple[np.ndarray, np.ndarray, int]:
    """(host codes, their sorted unique values, distinct live-code count)."""
    concrete = codes.cpu().numpy()
    u = np.unique(concrete)
    n_live = int(u.size) - int(u.size > 0 and u[-1] == PAD_GROUP)
    return concrete, u, n_live


def groupby_codes(codes: torch.Tensor, num_groups: int, *,
                  n_live: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resolve composite codes to (sorted unique codes, dense group ids).

    Padded codes (PAD_GROUP) map to the overflow segment ``num_groups``.
    More than ``num_groups`` distinct live codes would silently drop groups
    from every aggregate, so that raises.  The resolution runs on the host
    in numpy (the reference's concrete path); one ``np.unique`` yields both
    the live-code count and the group domain.
    """
    concrete, u, measured = _unique_codes(codes)
    if n_live is None:
        n_live = measured
    if n_live > num_groups:
        raise ValueError(
            f"group-by overflow: {n_live} distinct live group codes "
            f"exceed num_groups={num_groups}; the excess groups would "
            "silently vanish from every aggregate. Raise num_groups "
            f"(>= {n_live}) or coarsen the group keys.")
    u = u[:num_groups]
    uniq = np.full((num_groups,), PAD_GROUP, dtype=concrete.dtype)
    uniq[:u.size] = u
    gid = np.searchsorted(uniq, concrete).astype(np.int32)
    gid = np.where(concrete != PAD_GROUP, np.minimum(gid, num_groups),
                   num_groups).astype(np.int32)
    dev = codes.device
    return torch.from_numpy(uniq).to(dev), torch.from_numpy(gid).to(dev)


def auto_num_groups(codes: torch.Tensor) -> int:
    """Measured group-domain size: the distinct live codes (at least 1)."""
    return max(_unique_codes(codes)[2], 1)


def segment_aggregate(gid: torch.Tensor, values: torch.Tensor,
                      num_groups: int) -> torch.Tensor:
    """Σ values per group; values (n,) or (n, l)."""
    return segment_reduce(gid, values, num_groups, "sum")


_SCATTER_OPS = {"min": ("amin", float("inf")), "max": ("amax", float("-inf"))}


def segment_reduce(gid: torch.Tensor, values: torch.Tensor, num_groups: int,
                   op: str = "sum") -> torch.Tensor:
    """Per-group sum/min/max into ``G+1`` slots, overflow slot dropped.

    Group slots that receive no row come back as the identity (±inf for
    min/max) and are zeroed, as the reference does.
    """
    if op not in ("sum", "min", "max"):
        raise ValueError(f"segment_reduce op {op!r} not one of "
                         "['max', 'min', 'sum']")
    idx = gid.to(torch.int64)
    shape = (num_groups + 1,) + tuple(values.shape[1:])
    if op == "sum":
        out = torch.zeros(shape, dtype=values.dtype, device=values.device)
        return out.index_add_(0, idx, values)[:num_groups]
    reduce, ident = _SCATTER_OPS[op]
    out = torch.full(shape, ident, dtype=values.dtype, device=values.device)
    if values.dim() > 1:
        idx = idx[:, None].expand_as(values)
    out = out.scatter_reduce_(0, idx, values, reduce=reduce,
                              include_self=True)[:num_groups]
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def matmul_aggregate(gid: torch.Tensor, values: torch.Tensor,
                     num_groups: int) -> torch.Tensor:
    """Paper-faithful Fig. 4 aggregation: onehot(gid)ᵀ @ values.

    Overflow rows (gid == num_groups) get an all-zero one-hot row.
    """
    groups = torch.arange(num_groups, device=gid.device)
    onehot = (gid[:, None] == groups[None, :]).to(values.dtype)
    return onehot.T @ values


def decode_composite(codes: torch.Tensor, bounds: Sequence[int]
                     ) -> Tuple[torch.Tensor, ...]:
    """Invert ``composite_code`` (for presenting results)."""
    cols = []
    rem = codes
    for b in reversed(list(bounds)):
        cols.append(torch.remainder(rem, int(b)))
        rem = torch.div(rem, int(b), rounding_mode="floor")
    return tuple(reversed(cols))
