"""Peaks of the card and the least work of a query, from its shapes alone.

The peaks are NVIDIA's published H100 SXM figures at its 700 W limit, as
``chip_smoke.py::bound`` uses them.  The byte and operation counts depend
only on the query spec and the table sizes, never on what implements the
head (fused or not, kernel or not).
"""
from __future__ import annotations

from typing import Dict, Tuple

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
WORD = 4          # int32 keys, float32 values


def head_work(qspec: dict, rows: Dict[str, int], model: dict, l: int
              ) -> Tuple[int, int]:
    """(bytes, fp32 operations) of the prediction matrix: every fact FK
    column of the arms read once, each arm's named feature columns read
    once, the parameters read once, the (fact rows, l) matrix written once;
    the operations of the fused form, an add per arm and output (and a
    compare per output for a tree)."""
    n = rows[qspec["fact"]]
    arms = qspec["arms"]
    nbytes = n * WORD * len(arms)
    nbytes += sum(rows[a["table"]] * WORD * len(a.get("features", ()))
                  for a in arms)
    nbytes += param_bytes(model)
    nbytes += n * l * WORD
    ops = n * l * (len(arms) + (model["kind"] == "tree"))
    return nbytes, ops


def param_bytes(model: dict) -> int:
    """A head's parameters: the (k, l) matrix, or a feature id and a
    threshold per tree node."""
    if model["kind"] == "linear":
        return model["L"].size * WORD
    return len(model["feature"]) * 2 * WORD


def least_s(nbytes: int, ops: int) -> Tuple[float, str]:
    """The least time the card could take, and what bounds it."""
    return max((nbytes / HBM_BYTES_PER_S, "bytes"),
               (ops / FP32_FLOPS_PER_S, "operations"))


def _expr_ops(expr) -> int:
    return 0 if isinstance(expr, str) else 1 + sum(
        _expr_ops(e) for e in expr[1:])


def _expr_cols(expr) -> set:
    if isinstance(expr, str):
        return {expr}
    return set().union(*(_expr_cols(e) for e in expr[1:]))


def query_work(qspec: dict, rows: Dict[str, int], model, l: int
               ) -> Tuple[int, int]:
    """(bytes, fp32 operations) of a whole query.  Bytes: every column it
    names read once, over its table's rows (the fact table's foreign-key,
    predicate, group and aggregated columns; each arm's predicate, feature
    and group columns), and the parameters once; no prediction matrix,
    which a fused query need not make.  Operations: a compare per
    predicate and row, the head's (``head_work``), and per fact row each
    aggregate's expression and an add per output column."""
    n = rows[qspec["fact"]]
    fact_cols = {a["fk"] for a in qspec["arms"]}
    fact_cols |= {p[0] for p in qspec["where"]}
    ops = n * len(qspec["where"])
    for agg in qspec["aggregates"]:
        if agg["value"] == "@prediction":
            ops += n * l
        else:
            fact_cols |= _expr_cols(agg["value"])
            ops += n * (_expr_ops(agg["value"]) + 1)
    nbytes = 0
    for a in qspec["arms"]:
        cols = {p[0] for p in a.get("where", ())} | set(a.get("features", ()))
        cols |= {g["col"] for g in qspec["group_by"]
                 if g["table"] == a["table"]}
        nbytes += rows[a["table"]] * WORD * len(cols)
        ops += rows[a["table"]] * len(a.get("where", ()))
    fact_cols |= {g["col"] for g in qspec["group_by"]
                  if g["table"] == qspec["fact"]}
    nbytes += n * WORD * len(fact_cols)
    if model is not None:
        nbytes += param_bytes(model)
        ops += head_work(qspec, rows, model, l)[1]
    return nbytes, ops
