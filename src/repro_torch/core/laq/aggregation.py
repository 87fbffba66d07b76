"""Group-by aggregation in LAQ (port of ``repro.core.laq.aggregation``).

* ``groupby_sum_matmul`` — paper-faithful single-column aggregation
  (Fig. 4): values into MAT_R, groups into MAT_S, multiply, reduce.
* ``groupby_sum_segment`` — the same query with rows mapped to dense group
  ids through the key domain and one segment sum.
* ``groupby_reduce`` — sort-unique group ids + sum/count/min/max/mean.
* ``composite_code`` — multi-column group keys as one int32 code.
* ``groupby_codes`` — codes → (sorted unique codes, dense group ids), with
  tensor operations on the codes' device (the reference's concrete path
  does it on the host in numpy; the results are the same).
* ``segment_aggregate`` / ``segment_reduce`` — per-group reductions into
  ``G+1`` slots (the last one collects padding and is dropped).
* ``matmul_aggregate`` — the paper's Fig. 4 one-hot matmul.

Rows whose group id is the overflow slot ``num_groups`` drop out of every
aggregate.  ``index_add_`` on CUDA adds with atomics, so float sums there
are not bit-reproducible from run to run; integer-valued data sums exactly.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .domain import key_domain, positions

PAD_GROUP = 2**31 - 1


def _segment_sum(values: torch.Tensor, gid: torch.Tensor,
                 segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: Σ values per segment id, ``segments`` slots."""
    out = torch.zeros((segments,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    return out.index_add_(0, gid.to(torch.int64), values)


def _segment_extreme(values: torch.Tensor, gid: torch.Tensor, segments: int,
                     op: str) -> torch.Tensor:
    """``jax.ops.segment_min``/``segment_max``: empty segments hold the
    identity (±inf)."""
    reduce, ident = _SCATTER_OPS[op]
    out = torch.full((segments,) + tuple(values.shape[1:]), ident,
                     dtype=values.dtype, device=values.device)
    idx = gid.to(torch.int64)
    if values.dim() > 1:
        idx = idx.reshape((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    return out.scatter_reduce_(0, idx, values, reduce=reduce,
                               include_self=True)


# --------------------------------------------------------------------------
# Paper-faithful matmul path (single column, Fig. 4)
# --------------------------------------------------------------------------
def groupby_sum_matmul(keys_r: torch.Tensor, values_r: torch.Tensor,
                       keys_s: torch.Tensor, groups_s: torch.Tensor,
                       domain_size: int, num_groups: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SELECT SUM(R.val) FROM R JOIN S ON R.key=S.key GROUP BY S.val.

    Returns (group_values[num_groups] int32, sums[num_groups] float32);
    unused group slots hold PAD_GROUP / 0.
    """
    dev = keys_r.device
    dom = key_domain([keys_r, keys_s], domain_size)
    slots = torch.arange(dom.shape[0], device=dev)
    pos_r = positions(dom, keys_r)
    # MAT_R: values scattered to key-domain slots.
    mat_r = ((pos_r[:, None] == slots[None, :]).to(values_r.dtype)
             * values_r[:, None])
    groups = groups_s.to(torch.int32)
    grp_vals = key_domain([groups], num_groups)      # sorted unique, padded
    gid_s = positions(grp_vals, groups)
    pos_s = positions(dom, keys_s)
    # MAT_S[g, d] = 1 iff some S row has key slot d and group g.
    onehot_g = gid_s[:, None] == torch.arange(num_groups, device=dev)[None, :]
    onehot_d = pos_s[:, None] == slots[None, :]
    mat_s = onehot_g.to(torch.float32).T @ onehot_d.to(torch.float32)
    mat_s = mat_s.clamp(max=1.0)                     # de-duplicate keys
    # ones @ MAT_R @ MAT_Sᵀ: reduce rows, then map domain slots to groups.
    per_slot = mat_r.sum(0)
    return grp_vals, mat_s @ per_slot


def groupby_sum_segment(keys_r: torch.Tensor, values_r: torch.Tensor,
                        keys_s: torch.Tensor, groups_s: torch.Tensor,
                        domain_size: int, num_groups: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Optimized counterpart of ``groupby_sum_matmul`` (same signature).

    Maps each R row to its S group through the key domain and reduces with
    one segment sum instead of building MAT_R / MAT_S.  Requires unique
    live S keys (the PK side of a star schema).
    """
    dom = key_domain([keys_r, keys_s], domain_size)
    n_dom = int(dom.shape[0])
    pos_r = positions(dom, keys_r)
    pos_s = positions(dom, keys_s)
    groups = groups_s.to(torch.int32)
    grp_vals = key_domain([groups], num_groups)
    gid_s = positions(grp_vals, groups)
    # slot -> group id (one writer per live slot: unique S keys); missing
    # slots and padded S rows land in the overflow segment.
    slot_gid = torch.full((n_dom + 1,), num_groups, dtype=torch.int32,
                          device=dom.device)
    slot_gid[pos_s.clamp(max=n_dom).to(torch.int64)] = gid_s.clamp(
        max=num_groups)
    slot_gid[n_dom] = num_groups
    gid_r = slot_gid[pos_r.to(torch.int64)]
    sums = _segment_sum(values_r, gid_r, num_groups + 1)[:num_groups]
    return grp_vals, sums


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


def groupby_reduce(codes: torch.Tensor, values: Sequence[torch.Tensor],
                   num_groups: int, ops: Sequence[str] = ("sum",)
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Sort-unique group ids + segment reductions (sum/count/min/max/mean).

    Returns (group_codes[num_groups], per-op aggregate arrays).  Group codes
    come out sorted (paper §2.5: sorting the key domain sorts the result).
    Groups that receive no row hold the segment identity (0, or ±inf for
    min/max), as the reference's do.
    """
    uniq = key_domain([codes], num_groups)
    gid = torch.searchsorted(uniq, codes, out_int32=True)
    live = codes != PAD_GROUP
    gid = torch.where(live, gid, num_groups)     # padding → overflow segment
    seg = num_groups + 1
    outs = []
    for v, op in zip(values, ops):
        if op == "sum":
            o = _segment_sum(v, gid, seg)[:-1]
        elif op == "count":
            o = _segment_sum(torch.ones_like(v), gid, seg)[:-1]
        elif op in ("min", "max"):
            fill = float("inf") if op == "min" else float("-inf")
            o = _segment_extreme(torch.where(live, v, fill), gid, seg,
                                 op)[:-1]
        elif op == "mean":
            s = _segment_sum(v, gid, seg)[:-1]
            c = _segment_sum(torch.ones_like(v), gid, seg)[:-1]
            o = s / c.clamp(min=1.0)
        else:
            raise ValueError(f"unknown aggregation op {op!r}")
        outs.append(o)
    return uniq, tuple(outs)


def _unique_codes(codes: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(sorted unique values of ``codes``, distinct live-code count), on
    the codes' device."""
    u = torch.unique(codes, sorted=True)
    n_live = int(u.shape[0]) - int(u.shape[0] > 0
                                   and int(u[-1]) == PAD_GROUP)
    return u, n_live


def groupby_codes(codes: torch.Tensor, num_groups: int, *,
                  n_live: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resolve composite codes to (sorted unique codes, dense group ids).

    Padded codes (PAD_GROUP) map to the overflow segment ``num_groups``.
    More than ``num_groups`` distinct live codes would silently drop groups
    from every aggregate, so that raises.  The resolution runs on the
    codes' device: one sorted ``torch.unique`` yields both the live-code
    count and the group domain, and ``torch.searchsorted`` the ids.
    """
    u, measured = _unique_codes(codes)
    if n_live is None:
        n_live = measured
    if n_live > num_groups:
        raise ValueError(
            f"group-by overflow: {n_live} distinct live group codes "
            f"exceed num_groups={num_groups}; the excess groups would "
            "silently vanish from every aggregate. Raise num_groups "
            f"(>= {n_live}) or coarsen the group keys.")
    u = u[:num_groups]
    uniq = torch.full((num_groups,), PAD_GROUP, dtype=codes.dtype,
                      device=codes.device)
    uniq[:u.shape[0]] = u
    gid = torch.searchsorted(uniq, codes, out_int32=True)
    gid = torch.where(codes != PAD_GROUP, gid.clamp(max=num_groups),
                      num_groups)
    return uniq, gid.to(torch.int32)


def auto_num_groups(codes: torch.Tensor) -> int:
    """Measured group-domain size: the distinct live codes (at least 1)."""
    return max(_unique_codes(codes)[1], 1)


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
