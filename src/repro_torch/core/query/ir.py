"""Declarative IR for predictive queries (port of ``repro.core.query.ir``).

A ``PredictiveQuery`` is the logical plan the compiler lowers; every node is
data (frozen dataclasses + tuples).  Value expressions over fact columns are
tiny s-expressions::

    "lo_revenue"                          # a column
    ("mul", "lo_extendedprice", "lo_discount")

and the sentinel ``PREDICTION`` aggregates the model's output matrix.
Snowflake chains (``ChainLink``) are not ported yet: arms are flat.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from ..fusion.operators import DecisionTreeGEMM, LinearOperator
from ..laq.selection import Pred
from ..laq.table import Table

Model = Union[LinearOperator, DecisionTreeGEMM]

#: Comparison ops a PredictionFilter may use.
FILTER_OPS = ("==", "!=", "<", "<=", ">", ">=")

#: The functions behind FILTER_OPS (the reference keeps them in rewrite.py).
FILTER_FNS = {
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}

#: Aggregate.value sentinel: aggregate the (n, l) model prediction matrix.
PREDICTION = "@prediction"

#: Aggregate.value placeholder for ``count`` (COUNT(*) — value is ignored).
COUNT_STAR = "*"

#: Aggregate ops the compiler lowers.
AGG_OPS = ("sum", "count", "mean", "min", "max")

_BINOPS = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
}


@dataclasses.dataclass(frozen=True)
class ArmSpec:
    """One arm of the star: ``fact.fk_col = <table>.pk_col`` (paper §3.1).

    ``preds`` are dimension-side predicates, folded into the factored
    matching matrix's validity.
    """

    table: str
    fk_col: str
    pk_col: str
    feature_cols: Tuple[str, ...] = ()
    preds: Tuple[Pred, ...] = ()

    @property
    def feature_width(self) -> int:
        return len(self.feature_cols)


@dataclasses.dataclass(frozen=True)
class GroupKey:
    """One GROUP BY key column, drawn from the fact table or a joined arm.

    ``bound`` is an exclusive upper bound on ``col - offset``.
    """

    table: str                            # "fact" or an ArmSpec.table name
    col: str
    bound: int
    offset: int = 0


@dataclasses.dataclass(frozen=True)
class PredictionFilter:
    """A predicate over the model's prediction: ``op(P[:, output], value)``."""

    output: int
    op: str                               # one of FILTER_OPS
    value: float


@dataclasses.dataclass(frozen=True)
class Aggregate:
    """``op(value) [GROUP BY ...]``; ``value`` is an expr or ``PREDICTION``."""

    value: Union[str, tuple]
    op: str = "sum"
    name: str = "agg"


@dataclasses.dataclass(frozen=True, eq=False)
class PredictiveQuery:
    """σ(fact preds) ∧ ⋈(arms, with dim preds) → model → γ(group_keys, aggs)."""

    fact: str
    arms: Tuple[ArmSpec, ...]
    fact_preds: Tuple[Pred, ...] = ()
    model: Optional[Model] = None
    group_keys: Tuple[GroupKey, ...] = ()
    aggregates: Tuple[Aggregate, ...] = (Aggregate("lo_revenue"),)
    num_groups: Union[int, str] = 8192
    model_preds: Tuple[PredictionFilter, ...] = ()

    def __post_init__(self):
        if self.model_preds:
            if self.model is None:
                raise ValueError(
                    "model_preds filter the model's predictions, but the "
                    "query has no model head")
            for f in self.model_preds:
                if f.op not in FILTER_OPS:
                    raise ValueError(
                        f"prediction filter op {f.op!r} not one of "
                        f"{FILTER_OPS}")
                if not 0 <= int(f.output) < self.model.l:
                    raise ValueError(
                        f"prediction filter output {f.output} out of range "
                        f"for a model with l={self.model.l} outputs")
        seen = set()
        for a in self.arms:
            if a.table in seen:
                raise ValueError(
                    f"duplicate table alias {a.table!r} across the arms of "
                    f"query on fact {self.fact!r}: each dimension table may "
                    "join at most once")
            seen.add(a.table)

    @property
    def feature_width(self) -> int:
        return sum(a.feature_width for a in self.arms)


def eval_value(fact: Table, expr, *, query: Optional[str] = None
               ) -> torch.Tensor:
    """Evaluate a fact-column value expression to a (capacity,) float tensor.

    Unknown columns and malformed s-expressions raise a ``ValueError``
    naming the offending expression.
    """
    where = f" of query {query}" if query else ""
    if isinstance(expr, str):
        if expr in (PREDICTION, COUNT_STAR):
            raise ValueError(
                f"sentinel {expr!r} is not a fact column{where}: "
                "PREDICTION/COUNT_STAR are handled by the compiler, not "
                "eval_value")
        try:
            return fact.col(expr)
        except (KeyError, ValueError, IndexError) as e:
            raise ValueError(
                f"unknown column {expr!r} on table {fact.name!r} in value "
                f"expression{where}; available columns: "
                f"{list(fact.columns)}") from e
    if not isinstance(expr, tuple) or not expr or not isinstance(expr[0],
                                                                 str):
        raise ValueError(
            f"malformed value expression {expr!r}{where}: expected a column "
            "name or an ('op', ...) s-expression tuple")
    op, *args = expr
    if op == "col":
        if len(args) != 1 or not isinstance(args[0], str):
            raise ValueError(
                f"malformed value expression {expr!r}{where}: "
                "('col', name) takes exactly one column name")
        return eval_value(fact, args[0], query=query)
    if op not in _BINOPS:
        raise ValueError(
            f"unknown op {op!r} in value expression {expr!r}{where}; "
            f"expected one of {sorted(_BINOPS)} or 'col'")
    if len(args) != 2:
        raise ValueError(
            f"malformed value expression {expr!r}{where}: op {op!r} takes "
            f"2 arguments, got {len(args)}")
    vals = [eval_value(fact, a, query=query) for a in args]
    return _BINOPS[op](vals[0], vals[1])
