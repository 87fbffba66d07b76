"""The comparison that decides ``correct``.

Each answer the timed path produced is held against the reference answer
of its query:

* ``unanswered``: queries of the window that raised instead of answering;
* ``wrong_rows``: answers whose surviving-row count differs (exact);
* ``wrong_groups``: answers whose groups, decoded from the composite codes
  by the spec's bounds and offsets, are not the reference's (exact);
* ``sum_gap``: the widest gap of a float aggregate over every group and
  output column, measured against the sum of the absolute terms the
  reference added (the scale of a sum's float32 rounding):
  ``|got - want| / Σ|t|``, at most ``BAD`` (a value where the reference
  added nothing, a NaN);
* ``leaf_count_gap``: the widest gap, in rows, of a tree head's aggregate
  (rows per group and leaf: whole numbers that a sound run gets exactly).

A cell compares the gaps its workload file gives limits for, and each of
its queries has to fall under one of them; an exact comparison has
limit 0.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from .reference.answers import PREDICTION, Answer, decode

PAD_GROUP = 2**31 - 1
TINY = 1e-30
BAD = 1e30       # the gap of a non-finite value or of groups that differ
EXACT = ("unanswered", "wrong_rows", "wrong_groups")
GAPS = ("sum_gap", "leaf_count_gap")


def gap_kind(qspec: dict, agg: dict) -> str:
    """Which gap an aggregate of a query is measured by."""
    tree = qspec["model"] is not None and qspec["model"]["kind"] == "tree"
    return ("leaf_count_gap" if tree and agg["value"] == PREDICTION
            else "sum_gap")


def compare(out: Dict[str, np.ndarray], want: Answer, qspec: dict
            ) -> Tuple[bool, bool, Dict[str, float]]:
    """(rows equal, groups equal, the widest gap of each kind) of one
    answer; the gaps are ``BAD`` where the groups differ."""
    rows_ok = int(np.asarray(out["rows"]).reshape(())) == want.rows
    gb = qspec["group_by"]
    kinds = {gap_kind(qspec, a) for a in qspec["aggregates"]}
    if gb:
        codes = np.asarray(out["groups"]).reshape(-1)
        live = np.nonzero(codes != PAD_GROUP)[0]
        keys = decode(codes[live], gb)
        order = np.lexsort(keys.T[::-1]) if keys.shape[0] else live
        live, keys = live[order], keys[order]
    else:
        live = np.zeros(1, np.int64)
        keys = np.zeros((1, 0), np.int64)
    groups_ok = keys.shape == want.keys.shape and bool(
        np.array_equal(keys, want.keys))
    if not groups_ok:
        return rows_ok, False, {k: BAD for k in kinds}
    gaps = {k: 0.0 for k in kinds}
    for agg in qspec["aggregates"]:
        name, kind = agg["name"], gap_kind(qspec, agg)
        got = np.asarray(out[name], np.float64)
        got = (got.reshape(got.shape[0], int(np.prod(got.shape[1:])))
               if gb else got.reshape(1, -1))[live]
        d = np.abs(got - want.sums[name])
        if kind == "sum_gap":
            with np.errstate(invalid="ignore", divide="ignore"):
                d = d / np.maximum(want.mass[name], TINY)
        g = np.where(np.isfinite(d), d, BAD)
        if g.size:
            gaps[kind] = max(gaps[kind], min(float(np.max(g)), BAD))
    return rows_ok, True, gaps


def judge(answers: Iterable[Tuple[str, Optional[dict]]],
          wants: Dict[str, Answer], specs: Dict[str, dict],
          limits: Dict[str, float]) -> dict:
    """The numbers of a run's answers (``(query, host dict)``, None for a
    query that raised), each beside its limit, and ``correct``."""
    gaps = [k for k in GAPS if k in limits]
    for q, s in specs.items():
        for a in s["aggregates"]:
            if gap_kind(s, a) not in gaps:
                raise ValueError(f"{q}: no limit for its {gap_kind(s, a)}")
    n = {k: 0 for k in EXACT}
    n.update({k: 0.0 for k in gaps})
    seen = failed = 0
    for name, out in answers:
        seen += 1
        if out is None:
            n["unanswered"] += 1
            failed += 1
            continue
        rows_ok, groups_ok, got = compare(out, wants[name], specs[name])
        n["wrong_rows"] += not rows_ok
        n["wrong_groups"] += not groups_ok
        for k, v in got.items():
            n[k] = max(n[k], v)
        failed += not (rows_ok and groups_ok and all(
            v <= limits[k] for k, v in got.items()))
    lim = {k: 0 for k in EXACT}
    lim.update({k: limits[k] for k in gaps})
    checks = {k: {"value": n[k], "limit": lim[k]} for k in n}
    correct = seen > 0 and all(n[k] <= lim[k] for k in n)
    return {"correct": bool(correct), "compared": seen, "failed": failed,
            "checks": checks}
