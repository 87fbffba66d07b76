"""The detached fluent query builder (port of the builder half of
``repro.core.query.session``).

``query("lineorder").join(...).where(...).predict(model).group_by(...)
.agg(...).build()`` lowers to the ``PredictiveQuery`` IR.  The ``Session``
that executes builders is not ported yet: compile a built query with
``compile_query``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Sequence, Tuple, Union

from ..laq.selection import Pred
from .ir import (AGG_OPS, COUNT_STAR, PREDICTION, Aggregate, ArmSpec,
                 GroupKey, Model, PredictionFilter, PredictiveQuery)

_SEXPR_OPS = ("col", "add", "sub", "mul", "div")
_AGG_CALL = re.compile(r"^(sum|count|mean|min|max)\s*\(\s*(.*?)\s*\)$")


def _as_pred(spec) -> Pred:
    if isinstance(spec, Pred):
        return spec
    if isinstance(spec, tuple) and len(spec) == 3:
        return Pred(*spec)
    raise ValueError(f"unparseable predicate {spec!r}: expected a Pred or a "
                     "(col, op, value) tuple")


def _as_prediction_filter(spec) -> PredictionFilter:
    if isinstance(spec, PredictionFilter):
        return spec
    if isinstance(spec, tuple) and len(spec) == 3:
        return PredictionFilter(*spec)
    raise ValueError(
        f"unparseable prediction filter {spec!r}: expected a "
        "PredictionFilter or an (output, op, value) tuple")


def _as_group_key(spec) -> GroupKey:
    if isinstance(spec, GroupKey):
        return spec
    if isinstance(spec, tuple) and len(spec) in (3, 4):
        return GroupKey(*spec)
    raise ValueError(
        f"unparseable group key {spec!r}: expected a GroupKey or a "
        "(table, col, bound[, offset]) tuple ('fact' names the fact table)")


def _as_aggregate(name: str, spec) -> Aggregate:
    """One ``.agg(name=spec)`` entry → an :class:`Aggregate`.

    Accepted specs::

        "count"                      # COUNT(*) of surviving rows
        "sum(lo_revenue)"            # op(column) call syntax
        "lo_revenue"                 # bare column → sum
        ("mean", PREDICTION)         # (op, value)
        ("sub", "a", "b")            # bare s-expression value → sum
        Aggregate(...)               # passthrough, renamed to the kwarg
    """
    if isinstance(spec, Aggregate):
        return dataclasses.replace(spec, name=name)
    if isinstance(spec, tuple):
        if len(spec) == 2 and spec[0] in AGG_OPS:
            op, value = spec
            if op == "count":
                value = COUNT_STAR
            return Aggregate(value, op, name)
        if spec and spec[0] in _SEXPR_OPS:
            return Aggregate(spec, "sum", name)
        raise ValueError(
            f"unparseable aggregate {name}={spec!r}: tuple specs are "
            f"(op, value) with op in {list(AGG_OPS)} or an s-expression "
            f"starting with one of {list(_SEXPR_OPS)}")
    if isinstance(spec, str):
        s = spec.strip()
        if s in ("count", "count(*)", "count()"):
            return Aggregate(COUNT_STAR, "count", name)
        m = _AGG_CALL.match(s)
        if m:
            op, col = m.groups()
            if op == "count":
                return Aggregate(COUNT_STAR, "count", name)
            if not col:
                raise ValueError(
                    f"aggregate {name}={spec!r}: {op}() needs a column")
            return Aggregate(col, op, name)
        return Aggregate(s, "sum", name)
    raise ValueError(f"unparseable aggregate {name}={spec!r}")


@dataclasses.dataclass(frozen=True)
class QueryBuilder:
    """An immutable, fluent description of one predictive pipeline."""

    fact: str
    arms: Tuple[ArmSpec, ...] = ()
    fact_preds: Tuple[Pred, ...] = ()
    model: Optional[Model] = None
    group_keys: Tuple[GroupKey, ...] = ()
    aggregates: Tuple[Aggregate, ...] = ()
    num_groups: Union[int, str] = 8192
    model_preds: Tuple[PredictionFilter, ...] = ()

    def join(self, table: str, *, on: Tuple[str, str],
             features: Sequence[str] = (),
             where: Sequence = ()) -> "QueryBuilder":
        """Add one star arm: ``fact.<fk> = <table>.<pk>``."""
        if not (isinstance(on, tuple) and len(on) == 2):
            raise ValueError(f"join on={on!r}: expected (fk_col, pk_col)")
        fk, pk = on
        arm = ArmSpec(table, fk, pk, tuple(features),
                      tuple(_as_pred(p) for p in where))
        return dataclasses.replace(self, arms=self.arms + (arm,))

    def where(self, *preds) -> "QueryBuilder":
        """AND fact-side predicates (``Pred`` or ``(col, op, value)``)."""
        new = tuple(_as_pred(p) for p in preds)
        return dataclasses.replace(self, fact_preds=self.fact_preds + new)

    def predict(self, model: Model, *, where: Sequence = ()
                ) -> "QueryBuilder":
        """Attach the model head; ``where`` filters rows on the prediction."""
        filters = self.model_preds + tuple(
            _as_prediction_filter(f) for f in where)
        return dataclasses.replace(self, model=model, model_preds=filters)

    def group_by(self, *keys,
                 num_groups: Optional[Union[int, str]] = None
                 ) -> "QueryBuilder":
        """Add GROUP BY keys (``GroupKey`` or ``(table, col, bound[, offset])``)."""
        new = tuple(_as_group_key(k) for k in keys)
        kw: Dict = {"group_keys": self.group_keys + new}
        if num_groups is not None:
            kw["num_groups"] = num_groups
        return dataclasses.replace(self, **kw)

    def agg(self, **named) -> "QueryBuilder":
        """Add named aggregates; each kwarg is one result column."""
        new = tuple(_as_aggregate(n, s) for n, s in named.items())
        return dataclasses.replace(self, aggregates=self.aggregates + new)

    def build(self) -> PredictiveQuery:
        """Lower to the ``PredictiveQuery`` IR (the compiler contract)."""
        kw = dict(fact=self.fact, arms=self.arms,
                  fact_preds=self.fact_preds, model=self.model,
                  group_keys=self.group_keys, num_groups=self.num_groups,
                  model_preds=self.model_preds)
        if self.aggregates:
            kw["aggregates"] = self.aggregates
        elif self.model is not None:
            kw["aggregates"] = (Aggregate(PREDICTION, "sum", "prediction"),)
        return PredictiveQuery(**kw)


def query(fact: str) -> QueryBuilder:
    """A detached fluent builder (IR construction only)."""
    return QueryBuilder(fact=fact)
