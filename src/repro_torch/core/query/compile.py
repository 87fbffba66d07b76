"""Lower a ``PredictiveQuery`` to an executable plan (port of
``repro.core.query.compile``).

Offline (once per compile):
  1. selection masks on the fact table and each dimension (``Pred``, §2.2),
  2. factored matching matrices per arm (``PKIndex.probe``, §3.1), with the
     dimension-side predicate masks gathered through the FK pointers — the
     selection vector folded into the join validity,
  3. the model's linear prefix pushed into the dimension tables (Eq. 1/3),
  4. composite group codes + dense group ids (§2.4.2),
  5. the whole-query cost model choosing fused/nonfused, gather/matmul,
     segment/matmul and the serving kernel.

Online (``run`` / ``predictions`` / ``predict_rows``): Σⱼ Iⱼ Pⱼ gathers
(+ ``== h`` for trees), value expressions and the group-by reduction.  The
quasi-static arrays live in one state dict: per arm an ``(n,)`` int32
pointer column and an ``(n,)`` bool liveness column (columns a pooled plan
shares with other plans), and, when the plan's predictions run on
``fused_star_gather``, the same columns stacked ``(J, n)``, the layout
that kernel reads (an unpooled plan's columns are row views of it).

Incremental maintenance: the online functions read every quasi-static
tensor from the state dict, never from a closure, and the plan records the
:class:`~repro_torch.core.laq.catalog.Catalog` versions it was built
against.  :meth:`CompiledQuery.refresh` applies pending deltas to that
state with tensor operations on the tables' device (sorted-merge
``PKIndex.extend``, probes of the appended keys and fact rows, delta
``prefuse_rows``, the validity fold and the group ids); no fact-sized
tensor goes to the host.  Capacity growth, compaction, select-compaction
or a group-code overflow fall back to a recompile with a named reason.

Shared artifacts: with ``pool=`` (a ``Session``'s
:class:`~repro_torch.core.query.multiquery.ArtifactPool` over the same
catalog), the plan acquires its PK indices, join columns, predicate masks
and prefused partials from the pool, holds references to them until
``close()``, and its delta refresh reads the pool's entries, which the pool
updates once for all their holders.  The online phase is an
:class:`OnlineProgram` over the state, so ``Session.run_all`` can run a
class of compatible plans with each kernel launched once.

Snowflake chains (``ArmSpec.links``) collapse offline to head-granularity
virtual dimensions (:mod:`~repro_torch.core.query.snowflake`), overlaid on
the catalog; the flattened query then lowers through the same star
pipeline.  Before planning, the exact rewrite rules of
:mod:`~repro_torch.core.query.rewrite` run over the IR (``rewrite="on"``,
the default) and the cost model keeps the cheaper of the rewritten and the
original query; the trail is in ``plan.reason`` and ``explain()``.

Out of core: with ``stream_chunk_rows`` (or a ``memory_budget_bytes`` the
fact working set exceeds) ``run()`` folds the fact axis chunk by chunk
through a :class:`~repro_torch.core.query.streaming.StreamExecutor`, which
keeps the fact-axis leaves in host buffers (pinned on the card) and copies
two chunks at a time to the device; a streamed plan runs the fused
gather/segment program, and a delta refresh rebinds the executor's
buffers in place.

Meshes: with ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh`) each
arm's quasi-static row table for ``predict_rows`` (prefused partial, or
projected features) is placed per ``planner.place_tables`` and
``predict_rows`` runs as shard-local gathers merged over the model axis
(:mod:`~repro_torch.core.query.sharding`), equal to the single-device plain
path.  ``run``/``predictions`` stay single-device: they are fact-sized,
not partial-sized.  A mesh plan runs the plain gathers (no kernel), takes
no shared artifacts from a pool, and its delta refresh places the refreshed
tables again.
"""
from __future__ import annotations

import collections
import dataclasses
import warnings
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from ..fusion.operators import DecisionTreeGEMM
from ..fusion.pipeline import (PrefusedStar, extend_prefused, predict_fused,
                               predict_fused_kernel, predict_fused_matmul,
                               predict_nonfused, predict_nonfused_kernel,
                               predict_nonfused_matmul, prefuse)
from ..laq.aggregation import (auto_num_groups, composite_code,
                               groupby_codes, matmul_aggregate,
                               segment_aggregate, segment_reduce)
from ..laq.catalog import (Catalog, CatalogHistoryError, changed_spans,
                           rebuild_reason)
from ..laq.join import FactoredJoin, PKIndex, pk_index, stack_joins
from ..laq.projection import mapping_matrix
from ..laq.selection import select
from ..laq.star import DimSpec, StarJoin
from ..laq.table import PAD_KEY, Table
from .explain import ExplainReport
from .ir import (AGG_OPS, FILTER_FNS, PREDICTION, Aggregate, ArmSpec,
                 PredictiveQuery, eval_value)
from .planner import (SERVE_BACKENDS, QueryPlan, effective_serve_backend,
                      estimate_query_cost, place_tables,
                      plan_chain_materialization, plan_query, plan_streaming,
                      resolve_mesh_serve_backend)
from .rewrite import rewrite_query
from .sharding import (_take, make_predict_rows_forward, predict_rows_state,
                       shard_prefused_partials)
from .snowflake import (CollapsedChain, chain_dirty_heads, chain_tables,
                        flat_arm, link_parents, participating_tables,
                        refresh_chain, resolve_chain, virtual_name)
from .streaming import StreamExecutor, assert_pool_dimension_side


@dataclasses.dataclass
class CompiledQuery:
    """An executable plan: its online functions + quasi-static state.

    The state lives in ``_state``; ``catalog``/``versions`` record the data
    it was built against, and :meth:`refresh` brings it up to the catalog's
    current versions in place — by delta when shapes allow, by recompile
    otherwise.
    """

    query: PredictiveQuery
    plan: QueryPlan
    backend: str                    # "fused" | "nonfused"
    join_backend: str               # "gather" | "matmul"
    agg_backend: str                # "segment" | "matmul"
    serve_backend: str              # "torch" | "kernel"
    star: StarJoin
    prefused: Optional[PrefusedStar]
    selectivity: float              # measured fraction of surviving fact rows
    group_codes: Optional[torch.Tensor]   # sorted unique composite codes
    _rows: torch.Tensor                   # surviving-row count (int32)
    _run: Callable
    _predict: Optional[Callable]
    _predict_rows: Optional[Callable]
    _state: Dict
    catalog: Optional[Catalog] = None
    versions: Dict[str, int] = dataclasses.field(default_factory=dict)
    _indices: Tuple[PKIndex, ...] = ()   # per-arm PK indices (extendable)
    _source: Optional[PredictiveQuery] = None  # q as originally passed
    # Per-arm collapsed snowflake chains (None for flat arms; empty tuple
    # for all-flat queries).  ``query`` holds the flattened arms; the
    # chains carry the real head/link tables and the composed pointers the
    # refresh and group-by paths need.
    _chains: Tuple[Optional[CollapsedChain], ...] = ()
    _opts: Dict = dataclasses.field(default_factory=dict)
    # Bounded refresh-decision trail appended to plan.reason: a long-lived
    # plan must not grow its explain() string without limit.
    _refresh_notes: "collections.deque" = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=8))
    # Session-owned ArtifactPool sharing: the pool this plan acquired from
    # (None when compiled standalone) and the keys it holds references to —
    # {"arms": ((pkindex, join, dmask|None) per arm), "partials": (keys,)}.
    # ``close()`` releases them.
    _pool: Optional[object] = None
    _pool_refs: Dict = dataclasses.field(default_factory=dict)
    # The online phase as a program over the state; ``Session.run_all``
    # runs a class of compatible plans through it.
    _online_fn: Optional["OnlineProgram"] = None
    # Per-rule trail of core.query.rewrite (empty: no rule fired, or
    # rewrite="off").  ``query`` holds the rewritten IR the plan executes,
    # ``_source`` the query as written.
    _rewrites: Tuple[str, ...] = ()
    # Out-of-core executor (streaming.StreamExecutor) when the plan streams
    # the fact axis; ``run()`` goes through it instead of the in-core
    # program.  None on the in-core path.
    _stream: Optional[StreamExecutor] = None
    # The placed partials of a mesh plan (sharding.ShardedPrefusedPartials;
    # None without a mesh): its arms' specs drive the placement of
    # ``_state["sharded"]``, which ``predict_rows`` reads.
    _sp: Optional[object] = None

    @property
    def is_traced(self) -> bool:
        """Always False: the reference's contract allows it.

        The reference returns True for a plan compiled under an outer jit
        trace (its tensors are tracers and it must not be cached).  PyTorch
        runs eagerly, so a port plan always holds concrete tensors.
        """
        return False

    def run(self) -> Dict[str, torch.Tensor]:
        """Execute the query; returns aggregates (+ "groups", "rows").

        A streaming plan (``stream_chunk_rows``) folds the fact axis chunk
        by chunk through the same fused program (see
        :mod:`repro_torch.core.query.streaming` for what it equals).
        """
        if self._stream is not None:
            out = dict(self._stream.run())
        else:
            out = dict(self._run(_program_state(self._state)))
        if self.group_codes is not None:
            out["groups"] = self.group_codes
        out["rows"] = self._rows
        return out

    def predictions(self) -> torch.Tensor:
        """The (fact_capacity, l) prediction matrix (model queries only)."""
        if self._predict is None:
            raise ValueError("query has no model")
        return self._predict(_program_state(self._state))

    def predict_rows(self, row_ids) -> torch.Tensor:
        """Batched serving: predictions for a batch of fact row ids.

        Out-of-range ids follow the reference's plain (``jnp.take`` fill)
        semantics on both serve backends: NaN rows for linear heads, zero
        rows for fused tree heads (the non-fused tree sees NaN features and
        lands in its all-false leaf); negative ids wrap like numpy.
        """
        if self._predict_rows is None:
            raise ValueError("query has no model")
        ids = torch.as_tensor(row_ids, device=self._state["valid"].device)
        return self._predict_rows(ids.to(torch.int64), self._state)

    # -- introspection / lifecycle ------------------------------------------
    def _pool_keys(self) -> list:
        """Every pool key this plan holds a reference to (with
        multiplicity)."""
        keys = [k for ref in self._pool_refs.get("arms", ()) for k in ref
                if k is not None]
        keys.extend(self._pool_refs.get("partials", ()))
        return keys

    def explain(self) -> ExplainReport:
        """Structured plan/refresh report (``str()`` gives the decision
        line)."""
        return ExplainReport(
            kind="compiled", backend=self.backend,
            join_backend=self.join_backend, agg_backend=self.agg_backend,
            serve_backend=self.serve_backend,
            plan_reason=getattr(self, "_base_reason", self.plan.reason),
            trail=tuple(self._refresh_notes),
            shared_artifacts=tuple(self._pool_keys()),
            extras=(("selectivity", self.selectivity),
                    ("rewrites", self._rewrites),
                    ("stream", self._stream.describe()
                     if self._stream is not None else None)))

    def close(self) -> None:
        """Release this plan's shared-artifact references (idempotent).

        ``Session.evict`` calls this when dropping a cached plan; the pool
        evicts an artifact only when its last referencing plan closes.
        """
        if self._pool is not None and self._pool_refs:
            self._pool.release(self._pool_keys())
        self._pool_refs = {}

    # -- incremental maintenance --------------------------------------------
    def _participating(self) -> Tuple[str, ...]:
        return participating_tables(self._source or self.query)

    def refresh(self) -> str:
        """Apply pending catalog deltas to the plan's state, in place.

        Appends that fit the tables' capacity, non-key column updates and
        deletions take the delta path: per-arm ``PKIndex.extend`` sorted
        merges, probes of only the appended keys and fact rows,
        ``prefuse_rows`` over only the changed dimension rows, and the
        validity fold and group ids rebuilt — all shape-preserving, so the
        online functions read the swapped state as they are.  Capacity
        growth, compaction, select-compaction or a group-code overflow fall
        back to a full recompile.  Either way the decision is appended to
        ``plan.reason`` (visible through ``explain``) and returned.
        """
        if self.catalog is None:
            return self._note("refresh=no-op(detached: no catalog)")
        cat = self.catalog
        try:
            changed = {n: cat.deltas_since(n, self.versions.get(n, 0))
                       for n in self._participating()}
        except CatalogHistoryError:
            return self._recompile("history-compacted: plan staler than "
                                   "the delta log")
        changed = {n: d for n, d in changed.items() if d}
        if not changed:
            return self._note("refresh=no-op(versions unchanged)")
        if self._opts.get("select_capacity") is not None:
            return self._recompile("select-compaction rebinds the fact")
        why = rebuild_reason(changed)
        if why is not None:
            return self._recompile(why)
        try:
            return self._refresh_delta(changed)
        except _GroupOverflow:
            return self._recompile("group-overflow: live codes exceed the "
                                   "compiled num_groups")

    def _note(self, line: str) -> str:
        if not self._refresh_notes:
            self._base_reason = self.plan.reason
        self._refresh_notes.append(line)
        self.plan = dataclasses.replace(
            self.plan, reason="; ".join([self._base_reason,
                                         *self._refresh_notes]))
        return line

    def _recompile(self, why: str) -> str:
        # Recompile first (the fresh plan re-acquires the shared artifacts,
        # keeping their refcounts above zero), then release the old
        # references: releasing first would evict what the fresh compile is
        # about to rebuild.
        old_pool, old_keys = self._pool, self._pool_keys()
        fresh = compile_query(self.catalog, self._source, **self._opts)
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(fresh, f.name))
        if old_pool is not None:
            old_pool.release(old_keys)
        return self._note(f"refresh=recompile({why})")

    def _refresh_delta(self, changed) -> str:
        if self._pool is not None and self._pool_refs.get("arms"):
            return self._refresh_delta_pooled(changed)
        q = self.query
        cat = self.catalog
        fact = cat[q.fact]
        fspan = (changed_spans(changed[q.fact]).span
                 if q.fact in changed else None)
        dev = fact.device

        # Re-collapse the chains whose real tables changed (cached hops on
        # unchanged tables are reused); the per-arm pointer work below then
        # runs against the *head* table — the fact joins the head's PK at
        # head granularity, chain or no chain.
        chains = (list(self._chains) if self._chains
                  else [None] * len(q.arms))
        stale = set(changed)
        for j, ch in enumerate(chains):
            if ch is not None and stale & set(chain_tables(ch.arm)):
                chains[j] = refresh_chain(cat, ch, stale)
        overlay = _overlay(cat, chains)

        # Changed pointer columns are new tensors, never writes into the
        # ones the old state (and anything still holding it) reads.
        ptrs, founds = list(self._state["ptrs"]), list(self._state["founds"])
        indices = list(self._indices)
        dirty_rows = []
        for j, arm in enumerate(q.arms):
            ch = chains[j]
            head = ch.arm.table if ch is not None else arm.table
            dim = cat[head]
            # Deleted ids need no pointer, index or prefuse work: a
            # tombstone keeps the row's slot, key and data, so only the
            # validity fold (rebuilt by _assemble_star) changes.
            span, dirty, _, _ = (changed_spans(changed[head])
                                 if head in changed
                                 else (None, (), False, ()))
            ids = [torch.as_tensor(dirty, dtype=torch.int64, device=dev)]
            if span is not None:
                lo, hi = span
                ids.append(torch.arange(lo, hi, device=dev))
                nk = dim.key(arm.pk_col)[lo:hi]
                indices[j] = indices[j].extend(
                    nk, torch.arange(lo, hi, device=dev))
                # Fact rows whose FK now hits an appended PK: probe the
                # whole FK column against only the appended key block
                # (O(n log m)), scatter into ptr/found.
                order = torch.argsort(nk, stable=True)
                snk = nk[order]
                srow = (order + lo).to(torch.int32)
                fk = fact.key(arm.fk_col)
                posc = torch.searchsorted(snk, fk).clamp(max=hi - lo - 1)
                hit = (snk[posc] == fk) & (fk != PAD_KEY)
                ptrs[j] = torch.where(hit, srow[posc], ptrs[j])
                founds[j] = founds[j] | hit
            if fspan is not None:
                # Appended fact rows: probe their FKs against the (already
                # extended) full index, scatter into the new row span.
                flo, fhi = fspan
                fj = indices[j].probe(fact.key(arm.fk_col)[flo:fhi])
                if span is None:
                    ptrs[j], founds[j] = ptrs[j].clone(), founds[j].clone()
                ptrs[j][flo:fhi] = fj.ptr
                founds[j][flo:fhi] = fj.found
            if ch is not None:
                # Sub-dimension deltas dirty the head rows whose composed
                # pointers resolve into the touched link rows: those
                # virtual-matrix rows (and only those) differ from the old
                # collapse, so the partial scatter stays the cold one's.
                touched = {}
                for t in chain_tables(ch.arm):
                    if t in changed:
                        tspan, tdirty, _, _ = changed_spans(changed[t])
                        tids = [torch.as_tensor(tdirty, dtype=torch.int64,
                                                device=dev)]
                        if tspan is not None:
                            tids.append(torch.arange(tspan[0], tspan[1],
                                                     device=dev))
                        touched[t] = torch.cat(tids)
                dh = chain_dirty_heads(ch, touched)
                if dh is not None:
                    ids.append(dh.to(torch.int64))
            ids = torch.unique(torch.cat(ids))
            dirty_rows.append(ids if ids.numel() else None)

        # Validity, partials and group ids rebuild from the updated
        # pointers.  The mask fold is the same _assemble_star the cold
        # compile runs, so the refreshed validity is the cold one's.
        joins = tuple(FactoredJoin(p, f) for p, f in zip(ptrs, founds))
        dmasks = (tuple(c.dmask if c is not None else None for c in chains)
                  if any(c is not None for c in chains) else None)
        star, valid = _assemble_star(overlay, q, joins, dmasks=dmasks)
        prefused = self.prefused
        if prefused is not None:
            prefused = extend_prefused(prefused, star.dims, q.model,
                                       dirty_rows)
        self._indices = tuple(indices)
        self._chains = _chain_tuple(chains)
        return self._rebind(changed, star, valid, prefused,
                            "shapes kept, jit cache reused")

    def _refresh_delta_pooled(self, changed) -> str:
        """Delta refresh of a pool-backed plan.

        The shared artifacts (PK indices, join columns, predicate masks,
        prefused partials) come from the pool, which delta-updates each
        stale entry once however many plans reference it; only the per-plan
        rest — the validity fold, group ids and state — runs here.
        """
        q = self.query
        pool = self._pool
        chains = (list(self._chains) if self._chains
                  else [None] * len(q.arms))
        indices, joins, dmasks = [], [], []
        for j, (ikey, jkey, mkey) in enumerate(self._pool_refs["arms"]):
            indices.append(pool.get(ikey))
            ptr, found = pool.get(jkey)
            joins.append(FactoredJoin(ptr, found))
            mval = pool.get(mkey) if mkey is not None else None
            if isinstance(mval, CollapsedChain):
                # A chained arm's mask slot holds the pooled collapsed
                # chain, re-collapsed at most once for every plan sharing
                # it; the dmask and the virtual table come with it.
                chains[j] = mval
                mval = mval.dmask
            dmasks.append(mval)
        self._chains = _chain_tuple(chains)
        star, valid = _assemble_star(_overlay(self.catalog, chains), q,
                                     tuple(joins), dmasks=tuple(dmasks))
        prefused = self.prefused
        pkeys = self._pool_refs.get("partials", ())
        if pkeys:
            prefused = PrefusedStar(tuple(pool.get(k) for k in pkeys),
                                    prefused.h)
        self._indices = tuple(indices)
        return self._rebind(changed, star, valid, prefused,
                            "pooled artifacts, jit cache reused")

    def _rebind(self, changed, star, valid, prefused, how: str) -> str:
        """The delta refreshes' shared tail: group ids, counts and state.

        (The reference's lines say "jit cache reused": the port keeps its
        decision strings, and its online program reads the new state as it
        is.)
        """
        q = self.query
        cat = self.catalog
        uniq = gid = None
        if q.group_keys:
            cols, bounds = _group_columns(cat, q, star, self._chains)
            codes = composite_code(cols, bounds, valid)
            try:
                uniq, gid = groupby_codes(codes, q.num_groups)
            except ValueError as e:
                raise _GroupOverflow(str(e)) from e
        rows = valid.sum(dtype=torch.int32)
        old = self._state
        block = old["stacked_joins"]
        columns = (tuple(fj.ptr for fj in star.joins),
                   tuple(fj.found for fj in star.joins))
        if block is not None and not _same_tensors(
                columns, (old["ptrs"], old["founds"])):
            # Some join column changed: stack anew (the old stack stays
            # whole for whatever still holds it).
            star, block = _stack_for_kernel(star, pooled=bool(self._pool_refs))
        self.star = star
        self.prefused = prefused
        self.group_codes = uniq
        self._rows = rows
        self.selectivity = float(rows) / max(
            _static_int(star.fact.nvalid, star.fact.capacity), 1)
        state = _query_state(star, prefused, gid, block)
        if self._sp is not None:
            # A mesh plan places its refreshed row tables, pointers and
            # validity again, under the specs it was compiled with.
            state["sharded"] = predict_rows_state(
                self._sp, _row_tables(star, prefused, self.backend),
                [fj.ptr for fj in star.joins],
                [fj.found for fj in star.joins], valid)
        self._state = state
        if self._stream is not None:
            # Same capacity, same chunks: the executor copies the new
            # fact-axis leaves into its buffers in place.
            self._stream.rebind(_program_state(state))
        self.versions = {n: cat.version(n) for n in self._participating()}
        touched = ",".join(f"{n}+{len(changed[n])}"
                           for n in sorted(changed))
        return self._note(f"refresh=delta({touched}; {how})")


class _GroupOverflow(ValueError):
    """Internal: live group codes outgrew the compiled num_groups."""


def _static_int(x, default: int) -> int:
    """``int(x)``.

    The reference falls back to ``default`` when ``x`` is a jit tracer; a
    port tensor is always concrete, so this is just ``int(x)`` (``default``
    is kept for the reference's call sites).
    """
    return int(x)


def _overlay(catalog, chains):
    """The catalog with each collapsed chain's virtual table overlaid under
    its ``head->link->...`` name (the catalog itself when no arm chains)."""
    if not any(c is not None for c in chains):
        return catalog
    return {**catalog, **{c.table.name: c.table
                          for c in chains if c is not None}}


def _chain_tuple(chains) -> Tuple[Optional[CollapsedChain], ...]:
    """Per-arm chains as stored on a plan: empty for an all-flat query."""
    return tuple(chains) if any(c is not None for c in chains) else ()


def _assemble_star(catalog: Mapping[str, Table], q: PredictiveQuery,
                   joins: Tuple[FactoredJoin, ...],
                   dmasks: Optional[Tuple] = None
                   ) -> Tuple[StarJoin, torch.Tensor]:
    """Fold every selection mask into the combined validity, given resolved
    per-arm joins: fact predicates AND-fold, dimension predicates gather
    through the FK pointers, prediction filters fold last.

    The one definition of predicate semantics, shared by the cold compile
    and the delta refresh: the two must agree bit for bit.  ``dmasks``
    optionally supplies precomputed per-arm dimension masks (pool-shared);
    ``Pred.mask`` folds the table's validity itself, so a pooled
    ``valid ∧ preds`` mask is boolean-equal to the AND-fold done here.
    """
    fact = catalog[q.fact]
    valid = fact.valid_mask()
    for p in q.fact_preds:
        valid = valid & p.mask(fact)
    dims = []
    for j, (arm, fj) in enumerate(zip(q.arms, joins)):
        dim = catalog[arm.table]
        dims.append(DimSpec(dim, arm.fk_col, arm.pk_col, arm.feature_cols))
        ok = fj.found
        dmask = dmasks[j] if dmasks is not None else None
        if dmask is None and arm.preds:
            dmask = arm.preds[0].mask(dim)
            for p in arm.preds[1:]:
                dmask = dmask & p.mask(dim)
        if dmask is None and dim.deleted is not None:
            # ``Pred.mask`` folds the dimension's validity (tombstones
            # included), but an arm with no predicates has no mask to fold
            # through — gather the live mask so fact rows joined to a
            # tombstoned dimension row drop out.
            dmask = dim.valid_mask()
        if dmask is not None:
            ok = ok & dmask[fj.ptr]
        valid = valid & ok
    star = StarJoin(fact=fact, dims=tuple(dims), joins=tuple(joins),
                    row_valid=valid)
    if q.model_preds:
        preds = q.model.apply(star.materialize())
        for f in q.model_preds:
            valid = valid & FILTER_FNS[f.op](
                preds[:, f.output], torch.tensor(f.value, dtype=torch.float32,
                                                 device=preds.device))
        star = dataclasses.replace(star, row_valid=valid)
    return star, valid


def _resolve_star(catalog: Mapping[str, Table], q: PredictiveQuery,
                  pool=None, chains: Tuple = (), chain_keys: Tuple = ()
                  ) -> Tuple[StarJoin, torch.Tensor, Tuple[PKIndex, ...],
                             Tuple[tuple, ...]]:
    """Joins + combined validity with every selection mask folded in, and
    the per-arm ``PKIndex`` that ``refresh`` extends instead of re-sorting.

    With a ``pool``, indices, join columns and predicate masks are acquired
    from the shared :class:`~.multiquery.ArtifactPool` (computed once per
    distinct arm across all plans) and the per-arm reference keys are
    returned as the fourth element (empty when unpooled).

    Chained arms (``chains[j]`` not None) index and probe against the
    *real* head table, so two queries joining one head through different
    chains share one PK index and fact probe; their dimension mask is the
    chain's folded validity (in a pool, the mask slot holds the chain
    entry's key).
    """
    fact = catalog[q.fact]
    joins, indices, arm_refs, dmasks = [], [], [], []
    for j, arm in enumerate(q.arms):
        ch = chains[j] if j < len(chains) else None
        head = ch.arm.table if ch is not None else arm.table
        if pool is not None:
            idx, ikey = pool.acquire_pkindex(head, arm.pk_col)
            (ptr, found), jkey = pool.acquire_join(
                q.fact, arm.fk_col, head, arm.pk_col)
            fj = FactoredJoin(ptr, found)
            if ch is not None:
                dmask, mkey = ch.dmask, chain_keys[j]
            elif arm.preds:
                dmask, mkey = pool.acquire_dmask(arm.table, arm.preds)
            else:
                dmask = mkey = None
            arm_refs.append((ikey, jkey, mkey))
        else:
            idx = pk_index(catalog[head].key(arm.pk_col))
            fj = idx.probe(fact.key(arm.fk_col))
            dmask = ch.dmask if ch is not None else None
        dmasks.append(dmask)
        joins.append(fj)
        indices.append(idx)
    any_chain = any(c is not None for c in chains)
    star, valid = _assemble_star(
        catalog, q, tuple(joins),
        dmasks=(tuple(dmasks) if pool is not None or any_chain else None))
    return star, valid, tuple(indices), tuple(arm_refs)


def _group_columns(catalog: Mapping[str, Table], q: PredictiveQuery,
                   star: StarJoin, chains: Tuple = ()):
    """Exact int32 group-key columns, gathered through the arm pointers.

    A chained arm registers its real head and every link table: a
    sub-dimension group key composes the fact→head pointers with the
    chain's head→link pointers (the flat fact→link join's pointers).
    Misses gather row 0, which ``composite_code``'s validity fold masks.
    """
    arm_ptr = {}
    for j, (a, fj) in enumerate(zip(q.arms, star.joins)):
        ch = chains[j] if j < len(chains) else None
        if ch is None:
            arm_ptr[a.table] = fj.ptr
        else:
            arm_ptr[ch.arm.table] = fj.ptr
            for name, lptr, _found in ch.link_ptrs:
                arm_ptr[name] = lptr[fj.ptr]
    cols, bounds = [], []
    for gk in q.group_keys:
        if gk.table == "fact":
            c = star.fact.key(gk.col)
        else:
            c = catalog[gk.table].key(gk.col)[arm_ptr[gk.table]]
        cols.append(c - gk.offset)
        bounds.append(gk.bound)
    return cols, bounds


def _fact_row_bytes(fact: Table, q: PredictiveQuery, n_arms: int,
                    out_width: int) -> int:
    """Per-fact-row working-set bytes of the online program.

    State leaves (matrix columns, exact keys, per-arm pointer + liveness,
    validity, group id) plus the fact-sized intermediates the program
    makes (prediction rows, per-aggregate masked values): the quantity the
    streaming planner compares against the device budget (the reference's
    formula).
    """
    base = fact.ncols * 4 + len(fact.keys) * 4 + n_arms * 5 + 1 + 4
    inter = ((out_width * 4 if q.model is not None else 0)
             + 4 * max(len(q.aggregates), 1))
    return base + inter


def _out_widths(fact: Table, q: PredictiveQuery) -> Dict[str, Optional[int]]:
    """Per aggregate, the width of its values (None: one value per row).

    Predictions are ``(n, l)``; a value expression is evaluated on the
    fact's first row only, so no fact-sized pass is made.
    """
    one = dataclasses.replace(fact, matrix=fact.matrix[:1])
    widths = {}
    for agg in q.aggregates:
        if agg.op == "count":
            continue
        if agg.value == PREDICTION:
            widths[agg.name] = q.model.l
        else:
            v = eval_value(one, agg.value,
                           query=f"{agg.name!r} on {q.fact!r}")
            widths[agg.name] = int(v.shape[1]) if v.dim() > 1 else None
    return widths


def _check_aggregates(q: PredictiveQuery):
    if not q.aggregates:
        raise ValueError("query has no aggregates")
    names = [a.name for a in q.aggregates]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate aggregate names {names}: each "
                         "aggregate needs a distinct result column name")
    reserved = {"rows", "groups"} & set(names)
    if reserved:
        raise ValueError(f"aggregate names {sorted(reserved)} collide with "
                         "the reserved result keys 'rows'/'groups'")
    for agg in q.aggregates:
        if agg.op not in AGG_OPS:
            raise ValueError(
                f"aggregate op {agg.op!r} (aggregate {agg.name!r}) not one "
                f"of {list(AGG_OPS)}")
        if agg.value == PREDICTION and q.model is None:
            raise ValueError("PREDICTION aggregate requires a model")


def _query_state(star: StarJoin, prefused: Optional[PrefusedStar],
                 gid: Optional[torch.Tensor],
                 block: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> Dict:
    """Every tensor the online program reads; ``block`` is the ``(J, n)``
    stack of the join columns that ``fused_star_gather`` reads (None when
    the plan's predictions do not run it)."""
    return {
        "fact_matrix": star.fact.matrix,
        "valid": star.row_valid,
        "ptrs": tuple(fj.ptr for fj in star.joins),        # (n,) int32 each
        "founds": tuple(fj.found for fj in star.joins),    # (n,) bool each
        "stacked_joins": block,
        "dim_mats": tuple(d.dim.matrix for d in star.dims),
        "partials": (tuple(prefused.partials)
                     if prefused is not None else None),
        "h": prefused.h if prefused is not None else None,
        "gid": gid,
        "sharded": None,     # a mesh plan's placed predict_rows state
    }


def _program_state(state: Dict) -> Dict:
    """The state the single-device programs take: all but the mesh-placed
    ``"sharded"`` subtree, which only the sharded ``predict_rows`` reads."""
    return {k: v for k, v in state.items() if k != "sharded"}


def _stack_for_kernel(star: StarJoin, pooled: bool
                      ) -> Tuple[StarJoin, Tuple[torch.Tensor, torch.Tensor]]:
    """``(star, (ptrs, founds))``: the join columns stacked ``(J, n)``
    int32 / bool, the layout ``fused_star_gather`` reads.

    An unpooled plan's joins become row views of the stack, so it holds
    its columns once.  A pooled plan keeps the pool's shared columns and
    holds the stack as its own copy: the kernel reads one block (on an
    H100 it ran 14 % slower at the SF 10 P1 shape when it took the J
    columns as separate tensors).
    """
    ptrs, founds = stack_joins(star.joins)
    if not pooled:
        star = dataclasses.replace(star, joins=tuple(
            FactoredJoin(ptrs[j], founds[j]) for j in range(len(star.joins))))
    return star, (ptrs, founds)


def _star_view(star0: StarJoin, state: Dict) -> StarJoin:
    """The StarJoin skeleton rebound onto the state's arrays."""
    fact = dataclasses.replace(star0.fact, matrix=state["fact_matrix"])
    dims = tuple(
        dataclasses.replace(d, dim=dataclasses.replace(d.dim, matrix=m))
        for d, m in zip(star0.dims, state["dim_mats"]))
    joins = tuple(FactoredJoin(p, f)
                  for p, f in zip(state["ptrs"], state["founds"]))
    return StarJoin(fact=fact, dims=dims, joins=joins,
                    row_valid=state["valid"])


def _prefused_view(state: Dict) -> Optional[PrefusedStar]:
    if state["partials"] is None:
        return None
    return PrefusedStar(tuple(state["partials"]), state["h"])


def compile_query(catalog: Mapping[str, Table], q: PredictiveQuery, *,
                  backend: str = "auto", join_backend: str = "auto",
                  agg_backend: str = "auto", serve_backend: str = "auto",
                  select_capacity: Optional[int] = None,
                  batches_per_update: float = 1000.0,
                  memory_budget_bytes: Optional[int] = None,
                  stream_chunk_rows=None,
                  chain_strategy: str = "auto", rewrite: str = "on",
                  mesh=None, shard_axis: str = "model",
                  shard_threshold_bytes: Optional[int] = None,
                  pool=None) -> CompiledQuery:
    """Plan + lower ``q`` against ``catalog``.

    ``catalog`` may be a :class:`~repro_torch.core.laq.catalog.Catalog` —
    the versioned data surface whose mutations the plan absorbs through
    :meth:`CompiledQuery.refresh` — or any plain ``Mapping[str, Table]``,
    which is wrapped into a read-only Catalog (such plans never have
    pending deltas).  The plan runs on the device of the catalog's tables;
    the model head is moved there.  ``backend`` / ``join_backend`` /
    ``agg_backend`` override the planner ("auto" defers to the cost
    model).  ``serve_backend`` picks the physical kernel for
    ``predict_rows`` always, and for ``predictions``/``run`` when the join
    backend is "gather": "kernel" runs the fused gather-sum on
    ``fused_star_gather`` and non-fused trees on ``tree_predict``; "torch"
    runs the plain tensor code; "auto" picks the kernel on ``cuda`` when
    the shapes fit its bounds.

    ``select_capacity`` applies the fact predicates by ``mask_select``
    compaction before the joins; row ids seen by ``predict_rows`` then
    index the compacted table.

    ``stream_chunk_rows`` turns ``run()`` out of core: the fact axis goes to
    the device in chunks of that many rows (``"auto"`` sizes chunks to
    ``memory_budget_bytes``; the default ``None`` streams only when the
    budget is set and the fact working set exceeds it) through the fused
    online program, continuing the in-core fold (see
    :mod:`repro_torch.core.query.streaming`).  ``memory_budget_bytes`` is
    also a planner input: prefused partials above it plan nonfused.  The
    serving path (``predict_rows``) is request-batched and unaffected.

    ``chain_strategy`` says where along each snowflake chain to cache hop
    probes (``"auto"``: the planner's ``CHAIN_CACHE_BYTES`` budget;
    ``"through"``: none; ``"materialize"``: every hop); it changes refresh
    work, never results.  ``rewrite="on"`` runs the exact rewrite rules of
    :mod:`~repro_torch.core.query.rewrite` and keeps the rewritten query
    when the cost model scores it no dearer; ``"off"`` compiles the query
    as written.

    ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh`) shards the serving
    path: each arm's row table (prefused partial, or projected features)
    is placed per ``plan_partition_spec`` (replicated below
    ``shard_threshold_bytes``, else row-sharded over ``shard_axis``), and
    ``predict_rows`` becomes shard-local gathers summed over that axis
    (:mod:`~repro_torch.core.query.sharding`), equal to the single-device
    plain path.  ``run``/``predictions`` stay single-device.  ``mesh``
    runs the plain gathers: ``"auto"`` resolves to ``"torch"`` and
    ``"kernel"`` raises.

    ``pool`` is a :class:`~repro_torch.core.query.multiquery.ArtifactPool`
    (a ``Session`` passes its own): the plan then takes its PK indices,
    join columns, predicate masks, collapsed chains and prefused partials
    from it, sharing them with every other plan that needs the same ones.
    The pool engages only against its own catalog, without
    ``select_capacity`` and without a mesh.
    """
    for name, arg, allowed in (
            ("backend", backend, ("auto", "fused", "nonfused")),
            ("join_backend", join_backend, ("auto", "gather", "matmul")),
            ("agg_backend", agg_backend, ("auto", "segment", "matmul")),
            ("serve_backend", serve_backend, SERVE_BACKENDS),
            ("chain_strategy", chain_strategy,
             ("auto", "through", "materialize")),
            ("rewrite", rewrite, ("on", "off"))):
        if arg not in allowed:
            raise ValueError(f"{name} {arg!r} not one of {allowed}")
    serve_backend = resolve_mesh_serve_backend(serve_backend, mesh)
    _check_aggregates(q)
    if not isinstance(catalog, Catalog):
        warnings.warn(
            "passing a plain mapping to compile_query is deprecated and "
            "will require an explicit wrap in a future release; construct "
            "a repro_torch.core.laq.Catalog (or go through Session) — see "
            "the migration table in repro_torch.core.query",
            DeprecationWarning, stacklevel=2)
    cat0 = Catalog.wrap(catalog)
    for arm in q.arms:   # teach the catalog the join contract (PK columns)
        cat0.note_unique(arm.table, arm.pk_col)
        for lk in arm.links:
            cat0.note_unique(lk.table, lk.pk_col)
    source_q = q
    opts = dict(backend=backend, join_backend=join_backend,
                agg_backend=agg_backend, serve_backend=serve_backend,
                select_capacity=select_capacity,
                batches_per_update=batches_per_update,
                memory_budget_bytes=memory_budget_bytes,
                stream_chunk_rows=stream_chunk_rows,
                chain_strategy=chain_strategy, rewrite=rewrite, mesh=mesh,
                shard_axis=shard_axis,
                shard_threshold_bytes=shard_threshold_bytes, pool=pool)
    # Query/model co-optimization: run the exact rewrite rules over the IR,
    # then keep whichever of (original, rewritten) the cost model scores
    # cheaper.  ``_source`` stays the original query, so a refresh by
    # recompile reruns the rewrite from scratch.
    rewrite_trail: Tuple[str, ...] = ()
    if rewrite == "on":
        rw = rewrite_query(cat0, q)
        if rw.changed:
            def _cost(qq):
                return estimate_query_cost(
                    qq.model, cat0[qq.fact].capacity,
                    [cat0[a.table].capacity for a in qq.arms],
                    out_width=qq.model.l if qq.model is not None else 1,
                    batches_per_update=batches_per_update)
            cost_orig, cost_rw = _cost(q), _cost(rw.query)
            if cost_rw <= cost_orig:
                q = rw.query
                rewrite_trail = rw.trail
            else:
                rewrite_trail = (
                    f"rejected: cost {cost_rw:.3g} > {cost_orig:.3g}",)
    # Pool sharing engages only on the plain single-device path against
    # the pool's own catalog: select-compaction rebinds the fact to a local
    # table, and mesh placement holds per-device copies of its own.
    use_pool = (pool is not None and select_capacity is None
                and mesh is None and pool.catalog is cat0)
    # How many plans already share these join artifacts — measured before
    # this plan acquires (its own reference must not inflate the hint).
    sharing = pool.sharing_hint(q.fact, q.arms) if use_pool else 1.0
    catalog = cat0
    dev = catalog[q.fact].device
    for arm in q.arms:
        for t in chain_tables(arm):
            if catalog[t].device != dev:
                raise ValueError(
                    f"table {t!r} is on {catalog[t].device}, the fact "
                    f"table {q.fact!r} on {dev}: a plan runs on one device")
    if q.model is not None:
        q = dataclasses.replace(q, model=q.model.to(dev))
    if select_capacity is not None:
        fact = select(catalog[q.fact], q.fact_preds,
                      capacity=select_capacity)
        catalog = {**catalog, q.fact: fact}
        q = dataclasses.replace(q, fact_preds=())
    # Snowflake chains collapse offline to head-granularity virtual
    # dimensions (factored joins compose associatively, see
    # core.query.snowflake), overlaid on the catalog like the
    # select-compacted fact; the flattened query then lowers through the
    # unchanged star pipeline, bit for bit the chains materialized.
    chains: Tuple = ()
    chain_keys: Tuple = ()
    chain_notes = []
    if any(a.links for a in q.arms):
        ccs, ckeys = [], []
        for arm in q.arms:
            if not arm.links:
                ccs.append(None)
                ckeys.append(None)
                continue
            k, note = plan_chain_materialization(
                virtual_name(arm),
                [catalog[p].capacity for p in link_parents(arm)],
                strategy=chain_strategy, platform=dev.type)
            chain_notes.append(note)
            if use_pool:
                cc, ckey = pool.acquire_chain(arm, keep_hops=k)
            else:
                cc, ckey = resolve_chain(catalog, arm, keep_hops=k), None
            ccs.append(cc)
            ckeys.append(ckey)
        chains, chain_keys = tuple(ccs), tuple(ckeys)
        catalog = _overlay(catalog, chains)
        q = dataclasses.replace(q, arms=tuple(flat_arm(a) for a in q.arms))
    star, valid, indices, arm_refs = _resolve_star(
        catalog, q, pool=pool if use_pool else None, chains=chains,
        chain_keys=chain_keys)
    fact = star.fact
    rows = valid.sum(dtype=torch.int32)
    n_fact = _static_int(fact.nvalid, fact.capacity)
    sel = float(rows) / max(n_fact, 1)

    codes = None
    n_live = None
    if q.group_keys:
        cols, bounds = _group_columns(catalog, q, star, chains)
        codes = composite_code(cols, bounds, valid)
        if q.num_groups == "auto":
            n_live = auto_num_groups(codes)
            q = dataclasses.replace(q, num_groups=n_live)
    elif q.num_groups == "auto":
        q = dataclasses.replace(
            q, num_groups=PredictiveQuery.__dataclass_fields__[
                "num_groups"].default)

    out_width = q.model.l if q.model is not None else 1
    plan = plan_query(q.model, n_fact,
                      [_static_int(d.dim.nvalid, d.dim.capacity)
                       for d in star.dims],
                      platform=dev.type, selectivity=1.0,
                      num_groups=q.num_groups if q.group_keys else 0,
                      out_width=out_width,
                      agg_ops=tuple(a.op for a in q.aggregates),
                      batches_per_update=batches_per_update,
                      memory_budget_bytes=memory_budget_bytes,
                      sharing=sharing)
    if rewrite_trail:
        chain_notes.insert(0, "rewrite=[" + "; ".join(rewrite_trail) + "]")
    if chain_notes:
        plan = dataclasses.replace(
            plan, reason="; ".join([plan.reason, *chain_notes]))
    backend = plan.backend if backend == "auto" else backend
    join_backend = plan.join_backend if join_backend == "auto" else join_backend
    agg_backend = ((plan.agg.backend if plan.agg else "segment")
                   if agg_backend == "auto" else agg_backend)

    # Out-of-core decision: fact working-set bytes against the device
    # budget, or a chunk size the caller pins.  Streaming runs the fused
    # gather/segment program per chunk, the one lowering whose per-row bits
    # do not depend on chunking, so conflicting explicit overrides are
    # rejected rather than silently un-streamed.
    stream_rows = None
    if stream_chunk_rows is not None or memory_budget_bytes is not None:
        row_bytes = _fact_row_bytes(fact, q, len(star.dims), out_width)
        stream_rows, stream_reason = plan_streaming(
            stream_chunk_rows, fact.capacity, row_bytes,
            memory_budget_bytes)
        if (stream_rows is not None and stream_chunk_rows is None
                and q.model is not None and backend == "nonfused"
                and plan.fusion is not None
                and memory_budget_bytes is not None
                and plan.fusion.prefused_bytes > memory_budget_bytes):
            # The budget already ruled out resident prefused partials;
            # chunking the fact cannot shrink the dimension side, so the
            # budget-driven path defers to that choice.  An explicit chunk
            # size always streams.
            stream_rows = None
            stream_reason = "stream=off (budget forces nonfused prefuse)"
        if stream_reason:
            plan = dataclasses.replace(
                plan, stream_chunk_rows=stream_rows,
                reason=f"{plan.reason}; {stream_reason}")
    if stream_rows is not None:
        for name, val, bad in (("backend", opts["backend"], "nonfused"),
                               ("join_backend", opts["join_backend"],
                                "matmul"),
                               ("agg_backend", opts["agg_backend"],
                                "matmul")):
            if val == bad:
                raise ValueError(
                    f"stream_chunk_rows is incompatible with {name}="
                    f"{bad!r}: chunked execution folds partial aggregates "
                    "through the fused gather/segment program (matmul "
                    "lowerings are not bitwise chunk-stable)")
        if q.model is not None:
            backend = "fused"
        join_backend = "gather"
        agg_backend = "segment"
    serve_backend = effective_serve_backend(plan, serve_backend, backend,
                                            q.model, len(star.dims),
                                            platform=dev.type)
    if serve_backend != plan.serve_backend:
        plan = dataclasses.replace(
            plan, serve_backend=serve_backend,
            reason=f"{plan.reason}; serve={serve_backend} (caller override)")

    prefused = None
    partial_keys = ()
    if q.model is not None and backend == "fused":
        if use_pool:
            parts, h, partial_keys = pool.acquire_partials(
                star.dims, q.model, chains=chains)
            prefused = PrefusedStar(parts, h)
        else:
            prefused = prefuse(star, q.model)

    uniq = gid = None
    if q.group_keys:
        uniq, gid = groupby_codes(codes, q.num_groups, n_live=n_live)

    block = None
    if (q.model is not None and backend == "fused"
            and join_backend == "gather" and serve_backend == "kernel"):
        star, block = _stack_for_kernel(star, pooled=use_pool)
    state = _query_state(star, prefused, gid, block)

    reduce_fn = (matmul_aggregate if agg_backend == "matmul"
                 else segment_aggregate)
    model = q.model
    num_groups = q.num_groups
    aggregates = q.aggregates
    fact_desc = q.fact

    def _predictions(state):
        star_v = _star_view(star, state)
        pre_v = _prefused_view(state)
        if backend == "fused":
            if join_backend != "gather":
                return predict_fused_matmul(star_v, pre_v)
            if serve_backend == "kernel":
                ptrs, founds = state["stacked_joins"]
                return predict_fused_kernel(star_v, pre_v, ptrs=ptrs,
                                            founds=founds)
            return predict_fused(star_v, pre_v)
        if join_backend != "gather":
            return predict_nonfused_matmul(star_v, model)
        if serve_backend == "kernel":   # resolved only for tree heads
            return predict_nonfused_kernel(star_v, model)
        return predict_nonfused(star_v, model)

    def _agg_values(agg, pred, fact_v, valid_v):
        """Per-row values for one aggregate (sum-masked for additive ops)."""
        if agg.value == PREDICTION:
            return pred                          # already validity-masked
        vals = eval_value(fact_v, agg.value,
                          query=f"{agg.name!r} on {fact_desc!r}")
        if agg.op in ("min", "max"):
            return vals
        return torch.where(valid_v, vals, 0.0)

    def _predict_class(states):
        """``_predictions`` of each member of a stack class, each kernel
        launched once for the class."""
        if join_backend != "gather" or serve_backend != "kernel":
            return [_predictions(st) for st in states]
        if backend == "fused":
            return _fused_class(states)
        return _tree_class(states)   # "kernel" is resolved only for trees

    def _fused_class(states):
        from ...kernels.fused_star_gather import fused_star_gather
        # h is the model's: equal across the class (the stack key holds
        # the model's content).
        h = states[0]["h"]
        if all(_same_tensors((st["ptrs"], st["founds"], st["partials"]),
                             (states[0]["ptrs"], states[0]["founds"],
                              states[0]["partials"])) for st in states):
            # A session's class shares its pooled join columns and
            # partials; only validity and group ids differ, and validity
            # multiplies after the kernel: one launch over the shared rows.
            st = states[0]
            out = fused_star_gather(*st["stacked_joins"],
                                    list(st["partials"]), h)
            outs = [out] * len(states)
        else:
            # A member axis: the members' rows one after another, each
            # member's pointers clipped into its own partial (as the kernel
            # clips) and offset to that partial's rows in the concatenated
            # partial of its arm.
            ptrs, parts = [], []
            for j in range(len(star.joins)):
                off, pj = 0, []
                for st in states:
                    r = st["partials"][j].shape[0]
                    pj.append(st["ptrs"][j].clamp(0, r - 1) + off)
                    off += r
                ptrs.append(torch.cat(pj))
                parts.append(torch.cat([st["partials"][j]
                                        for st in states]))
            founds = torch.stack([torch.cat([st["founds"][j]
                                             for st in states])
                                  for j in range(len(star.joins))])
            out = fused_star_gather(torch.stack(ptrs).to(torch.int32),
                                    founds, parts, h)
            outs = out.split(states[0]["valid"].shape[0])
        return [o * st["valid"][:, None].to(o.dtype)
                for o, st in zip(outs, states)]

    def _tree_class(states):
        from ...kernels.tree_predict import tree_predict
        views = [_star_view(star, st) for st in states]
        if all(_same_tensors((st["dim_mats"], st["ptrs"], st["founds"]),
                             (states[0]["dim_mats"], states[0]["ptrs"],
                              states[0]["founds"])) for st in states):
            # Shared joined features T; member m's kernel input is T·valid_m.
            # tree_predict(T)·valid_m equals tree_predict(T·valid_m)·valid_m
            # bit for bit — a live row sees T·1 = T, and the kernel's 0/1
            # leaves of a dead row become 0 either way — so T is scored once.
            outs = [tree_predict(views[0].features().contiguous(), model.F,
                                 model.v, model.H, model.h)] * len(states)
        else:
            x = torch.cat([v.materialize() for v in views])
            outs = tree_predict(x.contiguous(), model.F, model.v, model.H,
                                model.h).split(states[0]["valid"].shape[0])
        return [o * st["valid"][:, None].to(o.dtype)
                for o, st in zip(outs, states)]

    def _aggregate(state, pred):
        fact_v = dataclasses.replace(fact, matrix=state["fact_matrix"])
        valid_v = state["valid"]
        gid_v = state["gid"]
        out = {}
        count = None
        if any(a.op in ("count", "mean") for a in aggregates):
            ones = valid_v.to(torch.float32)
            count = (reduce_fn(gid_v, ones, num_groups)
                     if gid_v is not None else ones.sum())
        for agg in aggregates:
            if agg.op == "count":
                out[agg.name] = count
                continue
            vals = _agg_values(agg, pred, fact_v, valid_v)
            if gid_v is not None:
                if agg.op in ("min", "max"):
                    out[agg.name] = segment_reduce(gid_v, vals, num_groups,
                                                   agg.op)
                elif agg.op == "mean":
                    s = reduce_fn(gid_v, vals, num_groups)
                    c = count.clamp(min=1.0)
                    out[agg.name] = s / (c[:, None] if s.dim() > 1 else c)
                else:
                    out[agg.name] = reduce_fn(gid_v, vals, num_groups)
            elif agg.op in ("min", "max"):
                fill = float("inf") if agg.op == "min" else float("-inf")
                mask = valid_v[:, None] if vals.dim() > 1 else valid_v
                masked = torch.where(mask, vals, fill)
                r = masked.amin(0) if agg.op == "min" else masked.amax(0)
                out[agg.name] = torch.where(torch.isfinite(r), r, 0.0)
            elif agg.op == "mean":
                out[agg.name] = vals.sum(0) / count.clamp(min=1.0)
            else:
                out[agg.name] = vals.sum(0)
        return out

    predict_fn = predict_rows_fn = None
    sp = None
    if model is not None:
        predict_fn = _predictions
        if mesh is not None:
            fwd, plan, state["sharded"], sp = _make_predict_rows_sharded(
                star, model, prefused, backend, plan, mesh, shard_axis,
                shard_threshold_bytes)

            def predict_rows_fn(ids, st):
                return fwd(ids, st["sharded"])
        else:
            predict_rows_fn = _make_predict_rows(star, model, backend,
                                                 serve_backend)
    program = OnlineProgram(
        predict=predict_fn, aggregate=_aggregate,
        predict_class=_predict_class if model is not None else None)

    stream = None
    if stream_rows is not None:
        stream = StreamExecutor(
            star=star, state=state, aggregates=aggregates, model=model,
            num_groups=num_groups if q.group_keys else 0,
            fact_desc=fact_desc, chunk_rows=stream_rows,
            out_widths=_out_widths(fact, q),
            use_kernel=model is not None and serve_backend == "kernel")
        if use_pool:
            # Pooled artifacts a streamed plan shares are dimension-side
            # and flow to every chunk unchanged.
            assert_pool_dimension_side(
                pool, {"arms": arm_refs, "partials": tuple(partial_keys)},
                state, star)

    return CompiledQuery(
        query=q, plan=plan, backend=backend, join_backend=join_backend,
        agg_backend=agg_backend, serve_backend=serve_backend, star=star,
        prefused=prefused, selectivity=sel, group_codes=uniq,
        _rows=rows, _run=program, _predict=predict_fn,
        _predict_rows=predict_rows_fn, _state=state, catalog=cat0,
        versions={n: cat0.version(n)
                  for n in participating_tables(source_q)},
        _indices=indices, _source=source_q, _chains=chains, _opts=opts,
        _pool=pool if use_pool else None,
        _pool_refs=({"arms": arm_refs, "partials": tuple(partial_keys)}
                    if use_pool else {}),
        _online_fn=program, _stream=stream, _rewrites=rewrite_trail,
        _sp=sp)


@dataclasses.dataclass(frozen=True)
class OnlineProgram:
    """A plan's online phase as a function of its state.

    ``predict(state)`` is the model head (None without one);
    ``aggregate(state, pred)`` the value expressions and group-by over the
    state and its predictions; ``predict_class(states)`` runs ``predict``
    for every member of a stack class with each kernel launched once for
    the class.  Calling the program runs one plan, on
    ``_program_state`` of its state (a mesh plan's placed ``"sharded"``
    subtree left out; mesh plans never stack).
    """

    predict: Optional[Callable]
    aggregate: Callable
    predict_class: Optional[Callable]

    def __call__(self, state: Dict) -> Dict[str, torch.Tensor]:
        pred = self.predict(state) if self.predict is not None else None
        return self.aggregate(state, pred)


def _same_tensors(a, b) -> bool:
    """Whether two nests of tuples hold the very same tensor objects."""
    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(_same_tensors(x, y) for x, y in zip(a, b)))
    return a is b


def _row_tables(star: StarJoin, prefused: Optional[PrefusedStar],
                backend: str):
    """Each arm's quasi-static row table for ``predict_rows``: its prefused
    partial (fused) or its projected feature rows (nonfused)."""
    if backend == "fused":
        return list(prefused.partials)
    return [d.dim.matrix @ mapping_matrix(d.dim.columns, d.feature_cols,
                                          device=d.dim.device)
            for d in star.dims]


def _make_predict_rows_sharded(star: StarJoin, model,
                               prefused: Optional[PrefusedStar],
                               backend: str, plan: QueryPlan, mesh,
                               shard_axis: str,
                               shard_threshold_bytes: Optional[int]):
    """The sharded ``predict_rows``: row tables placed on the mesh.

    Returns ``(forward, plan, sharded_state, sp)`` with the per-arm
    placement recorded on the plan.  The FK→row pointers were resolved
    offline, so the forward gathers by global pointer
    (``sharding.make_predict_rows_forward``); the placed tensors live in
    ``sharded_state``, which ``refresh`` places again.
    """
    tables = _row_tables(star, prefused, backend)
    h = prefused.h if backend == "fused" else None
    specs, plan = place_tables(mesh, tables, plan, axis=shard_axis,
                               threshold_bytes=shard_threshold_bytes)
    sp = shard_prefused_partials(
        mesh, [(d.fk_col, None, None, tbl)
               for d, tbl in zip(star.dims, tables)],
        h, specs, shard_axis=shard_axis)
    fn = make_predict_rows_forward(sp, model, backend)
    sharded_state = predict_rows_state(
        sp, tables, [fj.ptr for fj in star.joins],
        [fj.found for fj in star.joins], star.row_valid)
    return fn, plan, sharded_state, sp


def _make_predict_rows(star: StarJoin, model, backend: str,
                       serve_backend: str):
    """Row-batched prediction: the serving path (fact rows as requests).

    ``valid``, the pointers and the liveness are gathered with the
    reference's ``jnp.take`` fill rules first, so both serve backends see
    the same inputs.  The kernel clips an out-of-range pointer where the
    plain gather reads NaN; rows whose id is out of range are therefore set
    to what the plain path gives them (NaN, or 0 after a tree's compare).
    """
    if backend == "fused" and serve_backend == "kernel":
        from ...kernels.fused_star_gather import fused_star_gather

        def fn(ids, state):
            n = state["valid"].shape[0]
            wrapped = torch.where(ids < 0, ids + n, ids)
            oob = (wrapped < 0) | (wrapped >= n)
            v = _take(state["valid"], ids)
            ptrs = torch.stack([_take(p, ids) for p in state["ptrs"]])
            founds = torch.stack([_take(f, ids) for f in state["founds"]])
            out = fused_star_gather(ptrs, founds, list(state["partials"]),
                                    state["h"])
            fill = float("nan") if state["h"] is None else 0.0
            out = torch.where(oob[:, None], fill, out)
            return out * v[:, None].to(out.dtype)
        return fn

    if backend == "fused":
        def fn(ids, state):
            v = _take(state["valid"], ids)
            acc = None
            for j, part in enumerate(state["partials"]):
                ptr = _take(state["ptrs"][j], ids)
                hit = _take(state["founds"][j], ids)
                p = _take(part, ptr) * hit[:, None].to(part.dtype)
                acc = p if acc is None else acc + p
            acc = acc * v[:, None].to(acc.dtype)
            if state["h"] is None:
                return acc
            eq = (acc == state["h"][None, :].to(acc.dtype))
            return eq.to(acc.dtype) * v[:, None].to(acc.dtype)
        return fn

    use_kernel = (serve_backend == "kernel"
                  and isinstance(model, DecisionTreeGEMM))

    def fn(ids, state):
        v = _take(state["valid"], ids)
        parts = []
        for j, (d, mat) in enumerate(zip(star.dims, state["dim_mats"])):
            proj = mat @ mapping_matrix(d.dim.columns, d.feature_cols,
                                        device=mat.device)
            ptr = _take(state["ptrs"][j], ids)
            hit = _take(state["founds"][j], ids)
            parts.append(_take(proj, ptr) * hit[:, None].to(proj.dtype))
        t = torch.cat(parts, dim=1) * v[:, None].to(torch.float32)
        if use_kernel:
            from ...kernels.tree_predict import tree_predict
            out = tree_predict(t.contiguous(), model.F, model.v, model.H,
                               model.h)
        else:
            out = model.apply(t)
        return out * v[:, None].to(out.dtype)
    return fn


def query_from_star(star: StarJoin, *, model
                    ) -> Tuple[Dict[str, Table], PredictiveQuery]:
    """Lift an already-resolved ``StarJoin`` into (catalog, PredictiveQuery).

    For callers holding ``star_join`` outputs (the synthetic generator,
    serving): the compiler re-resolves the joins, so the result is the same
    as building the IR directly.  The query has one aggregate, the ``sum``
    of the model's predictions.
    """
    catalog = {star.fact.name: star.fact}
    arms = []
    for d in star.dims:
        catalog[d.dim.name] = d.dim
        arms.append(ArmSpec(d.dim.name, d.fk_col, d.pk_col,
                            tuple(d.feature_cols)))
    return catalog, PredictiveQuery(
        fact=star.fact.name, arms=tuple(arms), model=model,
        aggregates=(Aggregate(PREDICTION, "sum", "prediction"),))
