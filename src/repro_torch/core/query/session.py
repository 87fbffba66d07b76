"""``Session``: the single fluent entry point for predictive queries (port
of ``repro.core.query.session``).

A :class:`Session` binds a catalog (and optionally a device mesh) once, and
a fluent immutable
:class:`QueryBuilder` describes the pipeline declaratively::

    from repro_torch.core.query import Session, PREDICTION

    sess = Session(catalog)
    q = (sess.query("lineorder")
         .join("date", on=("lo_orderdate", "datekey"),
               features=["d_month"], where=[("d_year", "==", 1993)])
         .where(("lo_discount", "between", (1, 3)))
         .predict(model)
         .group_by(("date", "d_year", 8, 1992))
         .agg(revenue="sum(lo_revenue)", preds=("mean", PREDICTION),
              n="count"))

    q.run()                      # whole-query aggregates
    q.rows(batch)                # row predictions (CompiledQuery.predict_rows)
    q.serve(buckets=(8, 64))     # bucketed ServingRuntime (compile_serving)

Every builder step returns a new builder (frozen dataclass), so partial
pipelines are shareable and cacheable.  The builder lowers to the
:class:`~repro_torch.core.query.ir.PredictiveQuery` IR through
:meth:`QueryBuilder.build`.  Plan caching is structural: :func:`query_key`
hashes the IR by content (models by tensor bytes), so a builder-made query
and an equivalent hand-built one — or two builds of one registry entry —
share one compiled plan.  Every plan and runtime a session compiles takes
its shared artifacts from the session's
:class:`~repro_torch.core.query.multiquery.ArtifactPool`, and
:meth:`Session.run_all` runs compatible plans as one class.

Module-level :func:`query` starts a *detached* builder (no session) for
data-independent IR registries: ``.build()`` works, the execution verbs
need a session.

``Session(catalog, memory_budget_bytes=..., stream_chunk_rows=...)`` sets
out-of-core defaults for every plan it compiles (per-call overrides win;
serving runtimes take only the budget); see
:mod:`~repro_torch.core.query.streaming`.

``Session(catalog, mesh=..., shard_axis=..., shard_threshold_bytes=...)``
shards the serving state of every plan and runtime it compiles over a
:class:`~repro_torch.launch.mesh.Mesh` (per-call overrides win; see
:mod:`~repro_torch.core.query.sharding`).

``interpret`` has no meaning in the port: its kernels have no interpret
mode, and a CPU tensor takes the plain version.
"""
from __future__ import annotations

import dataclasses
import inspect
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from ..laq.catalog import Catalog
from ..laq.selection import Pred
from ..laq.table import Table
from .compile import CompiledQuery, compile_query
from .explain import ExplainReport
from .ir import (AGG_OPS, COUNT_STAR, PREDICTION, Aggregate, ArmSpec,
                 ChainLink, GroupKey, Model, PredictionFilter,
                 PredictiveQuery)
from .multiquery import (ArtifactPool, make_stacked_runner, model_key,
                         stack_key, stack_states)
from .scheduler import AdmissionScheduler, ScheduledPlan
from .serving import DEFAULT_BUCKETS, ServingRuntime, compile_serving
from .snowflake import chain_tables

_SEXPR_OPS = ("col", "add", "sub", "mul", "div")
_AGG_CALL = re.compile(r"^(sum|count|mean|min|max)\s*\(\s*(.*?)\s*\)$")


# --------------------------------------------------------------------------
# Structural plan-cache keys
# --------------------------------------------------------------------------
def query_key(q: PredictiveQuery) -> tuple:
    """Structural hash key of a ``PredictiveQuery``.

    Two structurally identical queries share one key even when they are
    distinct objects holding distinct (but value-equal) model tensors — the
    property the session's plan cache relies on, so registry builders that
    rebuild their IR per call still hit the cache.
    """
    return ("pq", q.fact, q.arms, q.fact_preds, model_key(q.model),
            q.group_keys, q.aggregates, q.num_groups, q.model_preds)


def _signature_defaults(fn) -> Dict:
    return {k: p.default for k, p in inspect.signature(fn).parameters.items()
            if p.default is not inspect.Parameter.empty}


#: Option defaults per entry point — the normalization tables behind
#: ``_opts_key``: an option spelled out at its default value gives the same
#: cache key as the option omitted.
_COMPILE_DEFAULTS = _signature_defaults(compile_query)
_SERVING_DEFAULTS = _signature_defaults(compile_serving)
_MISSING = object()


def _normalize_buckets(v) -> tuple:
    return tuple(sorted({int(b) for b in v}))


def _opts_key(opts: Mapping, *, defaults: Optional[Mapping] = None) -> tuple:
    """Hashable cache key for compile options, normalized.

    Equivalent spellings collapse to one key: options equal to the entry
    point's defaults are dropped (``backend="auto"`` ≡ omitted), bucket
    sequences are sorted, deduplicated and made ints, the shared pool
    never takes part (it is session plumbing, not a plan choice), and
    meshes key by identity (distinct meshes are distinct placements).
    """
    defaults = _COMPILE_DEFAULTS if defaults is None else defaults
    items = []
    for k in sorted(opts):
        if k == "pool":
            continue
        v = opts[k]
        if k == "buckets":
            v = _normalize_buckets(v)
        d = defaults.get(k, _MISSING)
        if d is not _MISSING:
            if k == "buckets":
                d = _normalize_buckets(d)
            if v is d or v == d:   # e.g. 1000 ≡ 1000.0: same compile
                continue
        items.append((k, id(v) if k == "mesh" else v))
    return tuple(items)


# --------------------------------------------------------------------------
# Spec parsing: preds / group keys / aggregates
# --------------------------------------------------------------------------
def _as_pred(spec) -> Pred:
    if isinstance(spec, Pred):
        return spec
    if isinstance(spec, tuple) and len(spec) == 3:
        return Pred(*spec)
    raise ValueError(f"unparseable predicate {spec!r}: expected a Pred or a "
                     "(col, op, value) tuple")


def _as_link(spec) -> ChainLink:
    """One ``.join(via=[...])`` entry → a :class:`ChainLink`.

    Accepted specs::

        ChainLink(...)                              # passthrough
        ("nation", "c_nationkey", "n_nationkey")    # (table, fk, pk
        (..., ["n_gdp"], [("n_region","==",1)],     #  [, features [, where
         "customer")                                #  [, parent]]])
        {"table": ..., "fk_col": ..., "pk_col": ...,
         "features": [...], "where": [...], "parent": ...}
    """
    if isinstance(spec, ChainLink):
        return spec
    if isinstance(spec, Mapping):
        d = dict(spec)
        preds = d.pop("where", d.pop("preds", ()))
        feats = d.pop("features", d.pop("feature_cols", ()))
        try:
            link = ChainLink(d.pop("table"), d.pop("fk_col"),
                             d.pop("pk_col"), tuple(feats),
                             tuple(_as_pred(p) for p in preds),
                             d.pop("parent", None))
        except KeyError as e:
            raise ValueError(
                f"unparseable chain link {spec!r}: missing key {e}") from e
        if d:
            raise ValueError(
                f"unparseable chain link {spec!r}: unknown keys {sorted(d)}")
        return link
    if isinstance(spec, tuple) and 3 <= len(spec) <= 6:
        table, fk, pk, *rest = spec
        feats = tuple(rest[0]) if len(rest) >= 1 else ()
        preds = tuple(_as_pred(p) for p in (rest[1] if len(rest) >= 2
                                            else ()))
        parent = rest[2] if len(rest) >= 3 else None
        return ChainLink(table, fk, pk, feats, preds, parent)
    raise ValueError(
        f"unparseable chain link {spec!r}: expected a ChainLink, a "
        "(table, fk_col, pk_col[, features[, where[, parent]]]) tuple, or "
        "a dict with those keys")


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
    """An immutable, fluent description of one predictive pipeline.

    Every method returns a new builder; :meth:`build` lowers to the
    ``PredictiveQuery`` IR.  The execution verbs (:meth:`run`,
    :meth:`rows`, :meth:`serve`, :meth:`compile`, :meth:`explain`) go
    through the bound session's plan cache; a detached builder
    (module-level :func:`query`) only supports :meth:`build`.
    """

    session: Optional["Session"]
    fact: str
    arms: Tuple[ArmSpec, ...] = ()
    fact_preds: Tuple[Pred, ...] = ()
    model: Optional[Model] = None
    group_keys: Tuple[GroupKey, ...] = ()
    aggregates: Tuple[Aggregate, ...] = ()
    num_groups: Union[int, str] = 8192
    model_preds: Tuple[PredictionFilter, ...] = ()

    # -- pipeline steps ------------------------------------------------------
    def join(self, table: str, *, on: Tuple[str, str],
             features: Sequence[str] = (),
             where: Sequence = (),
             via: Sequence = ()) -> "QueryBuilder":
        """Add one star arm: ``fact.<fk> = <table>.<pk>``.

        ``on=(fk_col, pk_col)``; ``features`` are dimension columns fed to
        the model (in join order); ``where`` holds dimension-side
        predicates (``Pred`` or ``(col, op, value)``), folded into the
        join's validity.  A bound builder checks the names against its
        session's catalog at once.

        ``via`` extends the arm into a snowflake chain: each entry (see
        :func:`_as_link`) hangs a sub-dimension off the head or an earlier
        link.  A bound builder also recognizes a *chained* join: when
        ``on``'s FK column is a key of an already joined dimension or link
        table rather than of the fact, the table attaches as a
        :class:`ChainLink` of the owning arm instead of a star arm::

            (sess.query("sales")
             .join("customer", on=("s_custkey", "c_custkey"))
             .join("nation", on=("c_nationkey", "n_nationkey"),
                   features=["n_gdp"]))        # chains off customer
        """
        if not (isinstance(on, tuple) and len(on) == 2):
            raise ValueError(f"join on={on!r}: expected (fk_col, pk_col)")
        fk, pk = on
        preds = tuple(_as_pred(p) for p in where)
        links = tuple(_as_link(lk) for lk in via)
        if not links:
            owner = self._link_parent(fk)
            if owner is not None:
                i, parent = owner
                link = ChainLink(table, fk, pk, tuple(features), preds,
                                 parent=parent)
                arm = dataclasses.replace(
                    self.arms[i], links=self.arms[i].links + (link,))
                self.session._check_arm(self.fact, arm)
                return dataclasses.replace(
                    self, arms=self.arms[:i] + (arm,) + self.arms[i + 1:])
        arm = ArmSpec(table, fk, pk, tuple(features), preds, links)
        if self.session is not None:
            self.session._check_arm(self.fact, arm)
        return dataclasses.replace(self, arms=self.arms + (arm,))

    def _link_parent(self, fk: str) -> Optional[Tuple[int, str]]:
        """``(arm_index, parent_table)`` when ``fk`` is a key of a joined
        dimension or link table (a chained join), None when it is a fact
        FK.  A detached builder has no catalog to look in and always
        returns None: chains there go through ``via=``."""
        if self.session is None:
            return None
        cat = self.session.catalog
        fact_t = cat.get(self.fact)
        if fact_t is not None and fk in fact_t.keys:
            return None
        matches = [(i, t) for i, a in enumerate(self.arms)
                   for t in chain_tables(a)
                   if t in cat and fk in cat[t].keys]
        if len(matches) > 1:
            raise ValueError(
                f"ambiguous chained join: FK column {fk!r} is a key of "
                f"multiple joined tables {sorted(t for _, t in matches)}; "
                "spell the chain out with via=[...]")
        return matches[0] if matches else None

    def where(self, *preds) -> "QueryBuilder":
        """AND fact-side predicates (``Pred`` or ``(col, op, value)``)."""
        new = tuple(_as_pred(p) for p in preds)
        return dataclasses.replace(self, fact_preds=self.fact_preds + new)

    def predict(self, model: Model, *, where: Sequence = ()
                ) -> "QueryBuilder":
        """Attach the model head; ``where`` filters rows on the prediction
        (``PredictionFilter`` or ``(output, op, value)``): a row survives
        only when ``op(prediction[output], value)`` holds.  For a tree, a
        filter selecting exactly one leaf is distilled by the rewrite
        engine into ordinary dimension predicates, and the model leaves
        the online phase."""
        filters = self.model_preds + tuple(
            _as_prediction_filter(f) for f in where)
        return dataclasses.replace(self, model=model, model_preds=filters)

    def group_by(self, *keys,
                 num_groups: Optional[Union[int, str]] = None
                 ) -> "QueryBuilder":
        """Add GROUP BY keys (``GroupKey`` or ``(table, col, bound[, offset])``).

        ``num_groups`` sizes the dense group dimension; ``"auto"`` defers
        to the compiler, which measures the live code domain.
        """
        new = tuple(_as_group_key(k) for k in keys)
        kw: Dict = {"group_keys": self.group_keys + new}
        if num_groups is not None:
            kw["num_groups"] = num_groups
        return dataclasses.replace(self, **kw)

    def agg(self, **named) -> "QueryBuilder":
        """Add named aggregates; each kwarg is one result column (see
        :func:`_as_aggregate` for the spec grammar)."""
        new = tuple(_as_aggregate(n, s) for n, s in named.items())
        return dataclasses.replace(self, aggregates=self.aggregates + new)

    # -- lowering ------------------------------------------------------------
    def build(self) -> PredictiveQuery:
        """Lower to the ``PredictiveQuery`` IR (the compiler contract)."""
        kw = dict(fact=self.fact, arms=self.arms,
                  fact_preds=self.fact_preds, model=self.model,
                  group_keys=self.group_keys, num_groups=self.num_groups,
                  model_preds=self.model_preds)
        if self.aggregates:
            kw["aggregates"] = self.aggregates
        elif self.model is not None:
            # No explicit aggregates on a model query: aggregate the
            # prediction matrix (as query_from_star does).
            kw["aggregates"] = (Aggregate(PREDICTION, "sum", "prediction"),)
        return PredictiveQuery(**kw)

    # -- execution (through the session) -------------------------------------
    def _bound(self) -> "Session":
        if self.session is None:
            raise ValueError(
                "detached builder: module-level query() only builds IR — "
                "use Session.query()/Session.bind() for run/rows/serve")
        return self.session

    def compile(self, **overrides) -> CompiledQuery:
        """The (cached) compiled plan; overrides are compile_query kwargs."""
        return self._bound().compile(self.build(), **overrides)

    def run(self, **overrides) -> Dict[str, torch.Tensor]:
        """Execute the whole-query aggregate program: the named aggregates
        (+ ``"groups"``/``"rows"``)."""
        return self.compile(**overrides).run()

    def rows(self, batch, **overrides) -> torch.Tensor:
        """Row predictions for a batch of fact row ids (serving-by-row)."""
        return self.compile(**overrides).predict_rows(batch)

    def serve(self, *, buckets: Sequence[int] = DEFAULT_BUCKETS,
              async_: bool = False,
              **overrides) -> "ServingRuntime | ScheduledPlan":
        """The (cached) bucketed dynamic-batch serving runtime.

        With ``async_=True`` the runtime is registered on the session's
        :meth:`Session.scheduler` and the returned :class:`ScheduledPlan`
        serves through the admission scheduler (``.submit(...)`` → Future)
        — for many concurrent callers sharing the plan.
        """
        runtime = self._bound().serving(self.build(), buckets=buckets,
                                        **overrides)
        if async_:
            return self._bound().scheduler().register(runtime)
        return runtime

    def explain(self, **overrides) -> ExplainReport:
        """Structured report for the compiled plan (``str()`` gives the
        one-line decision trail, ``as_dict()`` the machine-readable form)."""
        return self.compile(**overrides).explain()


# --------------------------------------------------------------------------
# The session
# --------------------------------------------------------------------------
class Session:
    """A catalog + execution context with one structural plan cache.

    Compiled plans and serving runtimes are cached by :func:`query_key` +
    options and the participating tables' catalog versions: identical
    pipelines compile once, whether built fluently, by hand or rebuilt from
    a registry, and a stale entry is never handed out — after a catalog
    mutation, the next lookup sees the version mismatch and brings the
    cached object up to date in place through its ``refresh()`` before
    returning it.

    ``catalog`` may be a mutable :class:`~repro_torch.core.laq.Catalog` or
    any plain ``Mapping[str, Table]``, which is wrapped read-only.  Plans
    run where the catalog's tables live; with a ``mesh``, their serving
    state is placed over it.
    """

    def __init__(self, catalog: "Mapping[str, Table] | Catalog", *,
                 mesh=None, shard_axis: str = "model",
                 shard_threshold_bytes: Optional[int] = None,
                 memory_budget_bytes: Optional[int] = None,
                 stream_chunk_rows: Optional[Union[int, str]] = None):
        self.catalog: Catalog = Catalog.wrap(catalog)
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.shard_threshold_bytes = shard_threshold_bytes
        # Out-of-core defaults: a device-memory budget and/or a fact chunk
        # size applied to every compile through this session (per-call
        # overrides win).  See core.query.streaming.
        self.memory_budget_bytes = memory_budget_bytes
        self.stream_chunk_rows = stream_chunk_rows
        # key → (versions-at-build, artifact); versions are re-checked (and
        # the artifact refreshed) on every hit.
        self._plans: Dict[tuple, Tuple[tuple, CompiledQuery]] = {}
        self._runtimes: Dict[tuple, Tuple[tuple, ServingRuntime]] = {}
        self._scheduler: Optional[AdmissionScheduler] = None
        # The multi-query optimizer's shared-artifact pool: every plan and
        # serving runtime compiled through this session acquires its PK
        # indices, join columns, predicate masks and prefused partials
        # here, so N plans sharing an arm reference one tensor and a
        # refresh updates it once.
        self.pool = ArtifactPool(self.catalog)
        # stack_key → (online program, stacked runner) for run_all.
        self._stacked: Dict[tuple, Tuple[object, object]] = {}

    # -- builders ------------------------------------------------------------
    def query(self, fact: str) -> QueryBuilder:
        """Start a fluent pipeline over catalog table ``fact``."""
        if fact not in self.catalog:
            raise KeyError(f"unknown fact table {fact!r}; catalog has "
                           f"{sorted(self.catalog)}")
        return QueryBuilder(session=self, fact=fact)

    def bind(self, q: PredictiveQuery) -> QueryBuilder:
        """Wrap an existing IR in a builder bound to this session."""
        return QueryBuilder(session=self, fact=q.fact, arms=q.arms,
                            fact_preds=q.fact_preds, model=q.model,
                            group_keys=q.group_keys,
                            aggregates=q.aggregates,
                            num_groups=q.num_groups,
                            model_preds=q.model_preds)

    def _check_arm(self, fact: str, arm: ArmSpec):
        """Early, named errors for a new join arm (builder ergonomics)."""
        if arm.table not in self.catalog:
            raise KeyError(f"unknown dimension table {arm.table!r}; "
                           f"catalog has {sorted(self.catalog)}")
        dim = self.catalog[arm.table]
        if arm.pk_col not in dim.keys:
            raise ValueError(
                f"join on {arm.table!r}: {arm.pk_col!r} is not a key column "
                f"(keys: {sorted(dim.keys)})")
        fact_t = self.catalog.get(fact)
        if fact_t is not None and arm.fk_col not in fact_t.keys:
            raise ValueError(
                f"join on {arm.table!r}: {arm.fk_col!r} is not a key column "
                f"of {fact!r} (keys: {sorted(fact_t.keys)})")
        missing = [c for c in arm.feature_cols if c not in dim.columns]
        if missing:
            raise ValueError(
                f"join on {arm.table!r}: unknown feature columns {missing} "
                f"(columns: {list(dim.columns)})")
        known = {arm.table: dim}
        prev = arm.table
        for lk in arm.links:
            parent_name = lk.parent if lk.parent is not None else prev
            parent_t = known.get(parent_name)
            if parent_t is None:
                raise ValueError(
                    f"chain link {lk.table!r} on arm {arm.table!r}: parent "
                    f"{parent_name!r} is not the head dimension or an "
                    f"earlier link (have: {sorted(known)})")
            if lk.fk_col not in parent_t.keys:
                raise ValueError(
                    f"chain link {lk.table!r}: {lk.fk_col!r} is not a key "
                    f"column of parent {parent_name!r} "
                    f"(keys: {sorted(parent_t.keys)})")
            if lk.table not in self.catalog:
                raise KeyError(
                    f"unknown sub-dimension table {lk.table!r}; catalog "
                    f"has {sorted(self.catalog)}")
            link_t = self.catalog[lk.table]
            if lk.pk_col not in link_t.keys:
                raise ValueError(
                    f"chain link {lk.table!r}: {lk.pk_col!r} is not a key "
                    f"column (keys: {sorted(link_t.keys)})")
            missing = [c for c in lk.feature_cols
                       if c not in link_t.columns]
            if missing:
                raise ValueError(
                    f"chain link {lk.table!r}: unknown feature columns "
                    f"{missing} (columns: {list(link_t.columns)})")
            known[lk.table] = link_t
            prev = lk.table

    # -- cached compilation --------------------------------------------------
    def _mesh_kwargs(self) -> Dict:
        """The session's mesh options, omitted without a mesh so the
        plan-cache keys of meshless sessions are unchanged."""
        if self.mesh is None:
            return {}
        return dict(mesh=self.mesh, shard_axis=self.shard_axis,
                    shard_threshold_bytes=self.shard_threshold_bytes)

    def _stream_kwargs(self, *, serving: bool = False) -> Dict:
        """Session-level out-of-core defaults, omitted when unset so the
        plan-cache keys of sessions without them are unchanged.  Serving
        runtimes batch by request rows, not fact scans, so only the memory
        budget (a planner input) applies there."""
        kw: Dict = {}
        if self.memory_budget_bytes is not None:
            kw["memory_budget_bytes"] = self.memory_budget_bytes
        if not serving and self.stream_chunk_rows is not None:
            kw["stream_chunk_rows"] = self.stream_chunk_rows
        return kw

    def _tables_of(self, q: PredictiveQuery, *, serving: bool = False
                   ) -> Tuple[str, ...]:
        """The catalog tables whose versions gate ``q``'s cached objects.

        Serving runtimes never read the fact table (requests are FK
        tuples), so fact mutations leave them valid.  Chained arms gate on
        every table along the chain: a sub-dimension append invalidates
        the collapsed chain as a head append does.
        """
        names = {t for a in q.arms for t in chain_tables(a)}
        if not serving:
            names.add(q.fact)
        return tuple(sorted(names))

    def compile(self, q: PredictiveQuery, **overrides) -> CompiledQuery:
        """The compiled plan for ``q`` (structurally + version cached).

        ``overrides`` are :func:`compile_query` keyword arguments and take
        part in the cache key, so another backend compiles a sibling plan.
        A cached plan built against older catalog versions is refreshed in
        place before it is returned.
        """
        opts = {"pool": self.pool, **self._mesh_kwargs(),
                **self._stream_kwargs(), **overrides}
        key = (query_key(q), _opts_key(opts))
        versions = self.catalog.versions(self._tables_of(q))
        hit = self._plans.get(key)
        if hit is not None:
            built_at, compiled = hit
            if built_at != versions:
                compiled.refresh()
                self._plans[key] = (versions, compiled)
            return compiled
        compiled = compile_query(self.catalog, q, **opts)
        self._plans[key] = (versions, compiled)
        return compiled

    def serving(self, q: PredictiveQuery, *,
                buckets: Sequence[int] = DEFAULT_BUCKETS,
                **overrides) -> ServingRuntime:
        """The dynamic-batch serving runtime for ``q`` (cached).

        Version-gated like :meth:`compile`: pending dimension mutations are
        applied through the runtime's refresh (fenced through the
        scheduler when it owns the runtime) before it is returned.
        """
        opts = {"pool": self.pool, **self._mesh_kwargs(),
                **self._stream_kwargs(serving=True), **overrides}
        key = ("serve", query_key(q),
               _opts_key({**opts, "buckets": tuple(buckets)},
                         defaults=_SERVING_DEFAULTS))
        versions = self.catalog.versions(self._tables_of(q, serving=True))
        hit = self._runtimes.get(key)
        if hit is not None:
            built_at, runtime = hit
            if built_at != versions:
                self._refresh_runtime(runtime)
                self._runtimes[key] = (versions, runtime)
            return runtime
        runtime = compile_serving(self.catalog, q, buckets=buckets, **opts)
        self._runtimes[key] = (versions, runtime)
        return runtime

    def _refresh_runtime(self, runtime: ServingRuntime) -> str:
        """Refresh one runtime, fencing through the scheduler if it owns it:
        a registered runtime may have batches in flight on the drain
        thread, and swapping its state under them would mix generations."""
        if self._scheduler is not None and not self._scheduler.closed \
                and self._scheduler.is_registered(runtime):
            return next(iter(
                self._scheduler.refresh(runtime).values()))
        return runtime.refresh()

    def refresh(self) -> Dict[str, str]:
        """Bring every cached plan and runtime up to the catalog's versions.

        One call after a batch of mutations applies the delta path
        everywhere, instead of each object paying it on its next lookup.
        Returns the per-object decision lines, keyed by a short descriptor.
        """
        out = {}
        for store, gate in ((self._plans, {}), (self._runtimes,
                                                {"serving": True})):
            for i, (key, (built_at, art)) in enumerate(list(store.items())):
                versions = self.catalog.versions(
                    self._tables_of(art.query, **gate))
                if built_at != versions:
                    desc = f"{art.__class__.__name__}[{art.query.fact}#{i}]"
                    if isinstance(art, ServingRuntime):
                        out[desc] = self._refresh_runtime(art)
                    else:
                        out[desc] = art.refresh()
                    store[key] = (versions, art)
        return out

    # -- batched multi-query execution ---------------------------------------
    def run_all(self, queries: Sequence, **overrides) -> List[Dict]:
        """Execute many queries, running compatible plans as one class.

        ``queries`` holds :class:`PredictiveQuery` IRs and/or bound
        :class:`QueryBuilder` pipelines.  Each compiles through the session
        cache (sharing pooled artifacts); plans whose stack key matches
        (same star shape, aggregates, model and state structure — see
        :func:`~repro_torch.core.query.multiquery.stack_key`) run through
        one stacked runner, which launches each kernel of their online
        phase once for the class.  Plans that cannot stack (sharded,
        streamed, compacted) run alone.  Results come back in input order
        and equal each
        ``compile(q).run()`` bit for bit.
        """
        plans = []
        for q in queries:
            if isinstance(q, QueryBuilder):
                q = q.build()
            plans.append(self.compile(q, **overrides))
        results: List[Optional[Dict]] = [None] * len(plans)
        groups: Dict[tuple, List[int]] = {}
        for i, p in enumerate(plans):
            sk = stack_key(p)
            if sk is None:
                results[i] = p.run()
            else:
                groups.setdefault(sk, []).append(i)
        for sk, idxs in groups.items():
            if len(idxs) == 1:           # nothing to batch with
                i = idxs[0]
                results[i] = plans[i].run()
                continue
            rep = plans[idxs[0]]
            cached = self._stacked.get(sk)
            if cached is None or cached[0] is not rep._online_fn:
                runner = make_stacked_runner(rep._online_fn)
                self._stacked[sk] = (rep._online_fn, runner)
            else:
                runner = cached[1]
            out = runner(stack_states([plans[i]._state for i in idxs]))
            for slot, i in enumerate(idxs):
                p = plans[i]
                r = {name: v[slot] for name, v in out.items()}
                if p.group_codes is not None:
                    r["groups"] = p.group_codes
                r["rows"] = p._rows
                results[i] = r
        return results

    def evict(self, q: Optional[PredictiveQuery] = None) -> int:
        """Drop cached plans and runtimes (all, or just those for ``q``).

        Closing each object releases its shared-pool references, so the
        last plan using an artifact frees it from the session pool.
        Returns the number of cache entries removed.
        """
        qk = None if q is None else query_key(q)
        removed = 0
        for store in (self._plans, self._runtimes):
            for key in list(store):
                this_qk = key[1] if key[0] == "serve" else key[0]
                if qk is not None and this_qk != qk:
                    continue
                _, art = store.pop(key)
                art.close()
                removed += 1
        if q is None:
            self._stacked.clear()
        return removed

    def scheduler(self, **opts) -> AdmissionScheduler:
        """The session's admission scheduler (lazy singleton).

        Created on first call; ``opts`` (``slo_ms``, ``max_queued_rows``,
        ``batch_reserve_rows``, ``auto_start``) only apply then — a later
        call with options on a live scheduler raises.
        ``QueryBuilder.serve(async_=True)`` registers its runtime here, and
        session-driven refreshes of registered runtimes fence through it.
        """
        if self._scheduler is None or self._scheduler.closed:
            self._scheduler = AdmissionScheduler(**opts)
        elif opts:
            raise ValueError(
                "session scheduler already running; close() it before "
                f"re-creating with new options {sorted(opts)}")
        return self._scheduler

    # -- introspection -------------------------------------------------------
    @property
    def num_plans(self) -> int:
        """Distinct compiled aggregate plans held by the cache."""
        return len(self._plans)

    @property
    def num_runtimes(self) -> int:
        """Distinct serving runtimes held by the cache."""
        return len(self._runtimes)


def query(fact: str) -> QueryBuilder:
    """A detached fluent builder (IR construction only, no session).

    ``query("lineorder").join(...).build()`` produces the same IR the
    equivalent ``Session.query`` chain would, and any session later
    compiles it with full cache sharing.
    """
    return QueryBuilder(session=None, fact=fact)
