"""A query's answer by plain joins, a plain model and plain sums.

Blocks of fact rows go through: fact predicates, a sorted-key probe of
each dimension, the dimension predicates at the matched rows, the group
key of each surviving row (a mixed-radix code over the spec's bounds), the
model (``X @ L``, or a walk down the tree node by node) and one
accumulator per (group, output column) for the sum and for the sum of
absolute terms, the scale the judge measures a gap against.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

PREDICTION = "@prediction"
BLOCK_ROWS = 1 << 22
MAX_CODES = 1 << 26

_CMP = {"==": torch.eq, "!=": torch.ne, "<": torch.lt, "<=": torch.le,
        ">": torch.gt, ">=": torch.ge}
_BIN = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
        "div": torch.div}


@dataclasses.dataclass
class Answer:
    """``rows`` surviving fact rows; per present group (ascending code) its
    key values; per aggregate the (groups, width) sums and sums of |term|."""

    rows: int
    keys: np.ndarray          # (groups, group keys) int64, ascending code
    sums: Dict[str, np.ndarray]
    mass: Dict[str, np.ndarray]


def _widen(col: torch.Tensor, dtype) -> torch.Tensor:
    return col.long() if not col.is_floating_point() else col.to(dtype)


def _pred(col: torch.Tensor, op: str, value) -> torch.Tensor:
    c = _widen(col, torch.float64)
    if op == "between":
        return (c >= value[0]) & (c <= value[1])
    if op == "in":
        return torch.isin(c, torch.tensor(value, dtype=c.dtype,
                                          device=c.device))
    return _CMP[op](c, torch.tensor(value, dtype=c.dtype, device=c.device))


def _stored(col: torch.Tensor, low: bool) -> torch.Tensor:
    """A float column as the arithmetic sees it: float64 in the reference,
    rounded to bfloat16 and held in float32 in the control."""
    if low:
        return col.to(torch.bfloat16).to(torch.float32)
    return col.to(torch.float64)


def _value(cols, expr, low):
    if isinstance(expr, str):
        return _stored(cols[expr], low)
    op, a, b = expr
    return _BIN[op](_value(cols, a, low), _value(cols, b, low))


def _mask(table, preds, lo=0, hi=None) -> Optional[torch.Tensor]:
    m = None
    for col, op, value in preds:
        t = _pred(table.columns[col][lo:hi], op, value)
        m = t if m is None else m & t
    return m


def _walk(x: torch.Tensor, feature: torch.Tensor, threshold: torch.Tensor,
          depth: int) -> torch.Tensor:
    """Leaf index of each row: level by level, right when x > threshold."""
    node = torch.zeros(x.shape[0], dtype=torch.long, device=x.device)
    leaf = torch.zeros_like(node)
    for _ in range(depth):
        right = (x.gather(1, feature[node][:, None])[:, 0]
                 > threshold[node]).long()
        leaf = leaf * 2 + right
        node = 2 * node + 1 + right
    return leaf


def answer(tables, qspec: dict, model: Optional[dict],
           precision: str = "float64", block_rows: int = BLOCK_ROWS
           ) -> Answer:
    """The answer of ``qspec`` over ``tables`` (``gen.RawTable``s)."""
    if precision not in ("float64", "bfloat16"):
        raise ValueError(f"precision {precision!r}")
    low = precision == "bfloat16"
    # float32 products of the control stay IEEE float32, never TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    acc_t = torch.float32 if low else torch.float64
    fact = tables[qspec["fact"]]
    dev = next(iter(fact.columns.values())).device
    n = fact.n

    arms = []
    for a in qspec["arms"]:
        dim = tables[a["table"]]
        pk = dim.columns[a["pk"]].long()
        order = torch.argsort(pk)
        dmask = _mask(dim, a.get("where", ()))
        feats = None
        if a.get("features"):
            feats = torch.stack([_stored(dim.columns[c], low)
                                 for c in a["features"]], dim=1)
        arms.append((a, order, pk[order], dmask, feats))
    arm_of = {a["table"]: j for j, a in enumerate(qspec["arms"])}

    bounds = [g["bound"] for g in qspec["group_by"]]
    n_codes = math.prod(bounds)
    if n_codes > MAX_CODES:
        raise ValueError(f"group code space {n_codes} too large")
    params = {}
    if model is not None and model["kind"] == "linear":
        params["L"] = _stored(torch.from_numpy(model["L"]).to(dev), low)
    elif model is not None:
        params["feature"] = torch.from_numpy(
            np.asarray(model["feature"], np.int64)).to(dev)
        params["threshold"] = _stored(
            torch.from_numpy(model["threshold"]).to(dev), low)
    widths = {}
    for agg in qspec["aggregates"]:
        if agg["op"] != "sum":
            raise ValueError(f"aggregate op {agg['op']!r}")
        widths[agg["name"]] = (
            (params["L"].shape[1] if "L" in params
             else 2 ** model["depth"])
            if agg["value"] == PREDICTION else 1)
    sums = {k: torch.zeros((n_codes, w), dtype=acc_t, device=dev)
            for k, w in widths.items()}
    mass = {k: torch.zeros((n_codes, w), dtype=torch.float64, device=dev)
            for k, w in widths.items()}
    count = torch.zeros(n_codes, dtype=torch.float64, device=dev)
    rows = 0

    for lo in range(0, n, block_rows):
        hi = min(n, lo + block_rows)
        valid = _mask(fact, qspec["where"], lo, hi)
        if valid is None:
            valid = torch.ones(hi - lo, dtype=torch.bool, device=dev)
        matched = []
        for a, order, spk, dmask, _ in arms:
            fk = fact.columns[a["fk"]][lo:hi].long()
            pos = torch.searchsorted(spk, fk).clamp(max=spk.shape[0] - 1)
            ok = spk[pos] == fk
            r = order[pos]
            if dmask is not None:
                ok &= dmask[r]
            valid &= ok
            matched.append(r)
        idx = valid.nonzero()[:, 0]
        rows += int(idx.shape[0])
        code = torch.zeros_like(idx)
        for g in qspec["group_by"]:
            if g["table"] == "fact":
                col = fact.columns[g["col"]][lo:hi][idx]
            else:
                j = arm_of[g["table"]]
                col = tables[g["table"]].columns[g["col"]][matched[j][idx]]
            v = col.long() - g.get("offset", 0)
            if bool(((v < 0) | (v >= g["bound"])).any()):
                raise ValueError(f"group key {g['col']} out of its bound")
            code = code * g["bound"] + v
        count.index_add_(0, code, torch.ones_like(code, dtype=torch.float64))
        pred = None
        if model is not None:
            x = torch.cat([feats[matched[j][idx]]
                           for j, (_, _, _, _, feats) in enumerate(arms)
                           if feats is not None], dim=1)
            if "L" in params:
                pred = x @ params["L"]
            else:
                leaf = _walk(x, params["feature"], params["threshold"],
                             model["depth"])
                pred = torch.nn.functional.one_hot(
                    leaf, 2 ** model["depth"]).to(acc_t)
        cols = {c: t[lo:hi][idx] for c, t in fact.columns.items()}
        for agg in qspec["aggregates"]:
            name = agg["name"]
            if agg["value"] == PREDICTION:
                vals = pred
            else:
                vals = _value(cols, agg["value"], low)[:, None]
            sums[name].index_add_(0, code, vals)
            mass[name].index_add_(0, code, vals.abs().to(torch.float64))

    present = (count > 0).nonzero()[:, 0] if bounds else torch.zeros(
        1, dtype=torch.long, device=dev)
    keys = decode(present.cpu().numpy(), qspec["group_by"])
    return Answer(
        rows=rows, keys=keys,
        sums={k: v[present].double().cpu().numpy() for k, v in sums.items()},
        mass={k: v[present].cpu().numpy() for k, v in mass.items()})


def decode(codes: np.ndarray, group_by) -> np.ndarray:
    """Mixed-radix codes (first key most significant) as (codes, keys)
    key values, offsets added back."""
    code = np.asarray(codes, np.int64).reshape(-1)
    out = []
    for g in reversed(group_by):
        code, v = np.divmod(code, g["bound"])
        out.append(v + g.get("offset", 0))
    return np.stack(out[::-1], axis=1) if out else np.zeros(
        (code.shape[0], 0), np.int64)
