"""Declarative IR for predictive queries (port of ``repro.core.query.ir``).

A ``PredictiveQuery`` is the logical plan the compiler lowers; every node is
data (frozen dataclasses + tuples).  Value expressions over fact columns are
tiny s-expressions::

    "lo_revenue"                          # a column
    ("mul", "lo_extendedprice", "lo_discount")

and the sentinel ``PREDICTION`` aggregates the model's output matrix.  An
arm may extend into a snowflake chain of sub-dimensions (``ChainLink``),
which the compiler collapses to one head-granularity virtual dimension.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple, Union

import numpy as np
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
class ChainLink:
    """One snowflake hop: ``<parent>.fk_col = <table>.pk_col``.

    A link hangs a sub-dimension off an arm's dimension or off an earlier
    link.  ``fk_col`` is a key column of the *parent* table; ``parent``
    names that table, or is ``None`` for the previous hop in declaration
    order (the arm's head dimension for the first link).  ``preds`` are
    sub-dimension predicates, folded into the chain's validity like flat
    dimension predicates.
    """

    table: str                            # catalog name of the sub-dimension
    fk_col: str                           # FK column on the parent table
    pk_col: str                           # PK column on this table
    feature_cols: Tuple[str, ...] = ()
    preds: Tuple[Pred, ...] = ()
    parent: Optional[str] = None          # None → previous hop / head dim


@dataclasses.dataclass(frozen=True)
class ArmSpec:
    """One arm of the star: ``fact.fk_col = <table>.pk_col`` (paper §3.1).

    ``preds`` are dimension-side predicates, folded into the factored
    matching matrix's validity.  ``links`` extends the arm into a
    multi-hop snowflake chain; factored joins compose associatively, so the
    compiler collapses the chain to one head-granularity virtual dimension
    (bit for bit the chain materialized as a flat join) before prefusing it.
    """

    table: str
    fk_col: str
    pk_col: str
    feature_cols: Tuple[str, ...] = ()
    preds: Tuple[Pred, ...] = ()
    links: Tuple[ChainLink, ...] = ()

    @property
    def feature_width(self) -> int:
        return (len(self.feature_cols)
                + sum(len(lk.feature_cols) for lk in self.links))


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
        # A duplicate table alias would shadow in every name-keyed
        # structure downstream (catalog overlays, group-key pointer maps,
        # serving version maps): reject it here, once.
        seen = set()
        for a in self.arms:
            for n in [a.table] + [lk.table for lk in a.links]:
                if n in seen:
                    raise ValueError(
                        f"duplicate table alias {n!r} across the arms/chains "
                        f"of query on fact {self.fact!r}: each dimension or "
                        "sub-dimension table may join at most once")
                seen.add(n)
            known = {a.table}
            for lk in a.links:
                if lk.parent is not None and lk.parent not in known:
                    raise ValueError(
                        f"chain link {lk.table!r} on arm {a.table!r} names "
                        f"parent {lk.parent!r}, which is not the arm's head "
                        "dimension or an earlier link (links must be "
                        "declared parent-first; self-referential chains are "
                        "invalid)")
                known.add(lk.table)

    @property
    def feature_width(self) -> int:
        return sum(a.feature_width for a in self.arms)

    # Content equality: two independently built but structurally identical
    # queries compare equal, model weights by value (digest), not identity.
    # The dataclass is eq=False, so these are the only equality semantics.
    def __eq__(self, other):
        if self is other:
            return True
        if not isinstance(other, PredictiveQuery):
            return NotImplemented
        return query_signature(self) == query_signature(other)

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __hash__(self):
        return hash(query_signature(self))


def _content_token(obj):
    """A hashable, by-value token for any IR node (tensors and arrays by a
    digest of their bytes, read on the host)."""
    if obj is None or isinstance(obj, (str, int, float, bool, bytes)):
        return obj
    if isinstance(obj, (tuple, list)):
        return tuple(_content_token(o) for o in obj)
    if isinstance(obj, (set, frozenset)):
        return ("set",) + tuple(sorted(repr(o) for o in obj))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return ((type(obj).__name__,)
                + tuple(_content_token(getattr(obj, f.name))
                        for f in dataclasses.fields(obj)))
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, np.ndarray):
        return ("array", str(obj.dtype), obj.shape,
                hashlib.sha1(np.ascontiguousarray(obj).tobytes()).hexdigest())
    return (type(obj).__name__, repr(obj))


def query_signature(q: PredictiveQuery) -> tuple:
    """The query's content signature (cached; tensors digested by value)."""
    sig = q.__dict__.get("_signature")
    if sig is None:
        sig = _content_token(q)
        object.__setattr__(q, "_signature", sig)
    return sig


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
