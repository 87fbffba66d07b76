"""Multi-query optimizer: shared artifacts across compiled plans (port of
``repro.core.query.multiquery``, one device).

The registry's queries each materialize the same quasi-static artifacts:
most share star arms, so most would recompute the same PK sort, the same
fact-sized FK probe, the same dimension predicate mask and, per model
prefix, the same Eq. 1 prefused partial.  This module makes that work
shareable at plan time:

Arm-level content keys
    ``("pkindex", table, pk_col)``, ``("join", fact, fk_col, table,
    pk_col)``, ``("dmask", table, preds)``, ``("features", table,
    feature_cols)`` and ``("partial", ...)`` keyed by the model-prefix
    slice content — so two queries sharing a (table, model prefix,
    predicate) arm resolve to the same artifact keys even when the rest of
    their plans differ.  A snowflake chain's collapse is keyed by the
    chain's content (``("chain", ...)``), and each of its hop probes is a
    ``join`` entry with the parent table on the probing side.

``ArtifactPool``
    A reference-counted store of those artifacts, owned by a ``Session``
    and bound to its :class:`~repro_torch.core.laq.catalog.Catalog`.
    ``acquire_*`` computes on a miss and hands back the shared tensors on a
    hit (the output of the very computation the unpooled compile runs, so
    bit-identical); ``release`` drops references and evicts at zero.  Every
    entry records the catalog versions it was built against and refreshes
    lazily, exactly once, when it is fetched stale: N plans sharing an
    artifact pay one delta update between them.  The delta math per kind is
    the unpooled refresh's (``PKIndex.extend`` sorted merges, probes of the
    appended keys and fact rows, ``prefuse_rows`` over the changed rows,
    mask scatters), all tensor operations on the tables' device.  A
    refreshed entry is a new tensor: the one the old value holds is never
    written, so a plan that has not refreshed yet keeps reading a
    consistent old state.

Stacked multi-query execution
    :func:`stack_key` classifies compiled plans into structural classes
    (same fact and arm shapes, backends, aggregate list, group dimension,
    model content and state signature — predicates and group ids live in
    the state, not the program).  :func:`make_stacked_runner` runs one
    class with each kernel of its online phase launched once for the whole
    class (the reference vmaps the jitted program instead); see
    :class:`~repro_torch.core.query.compile.OnlineProgram`.

Not ported here: ``holds_tracers``: PyTorch runs eagerly, so a pooled
compile never sees a tracer.

No compile/serving/session imports happen here (those modules receive the
pool as an opaque argument): ``session → {compile, serving, multiquery}``.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..fusion.operators import DecisionTreeGEMM, LinearOperator
from ..fusion.pipeline import _feature_slices, prefuse_dims, prefuse_rows
from ..laq.catalog import Catalog, CatalogHistoryError, changed_spans
from ..laq.join import FactoredJoin, PKIndex, pk_index
from ..laq.projection import mapping_matrix
from ..laq.star import DimSpec
from ..laq.table import PAD_KEY, Table
from .ir import ArmSpec, Model, PredictiveQuery
from .snowflake import (CollapsedChain, chain_dirty_heads, chain_key,
                        chain_tables, qualified_cols, resolve_chain,
                        virtual_name)


# --------------------------------------------------------------------------
# Content hashing (models by tensor bytes)
# --------------------------------------------------------------------------
def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _array_key(a) -> tuple:
    arr = _host(a)
    return (arr.shape, arr.dtype.str,
            hashlib.blake2b(np.ascontiguousarray(arr).tobytes(),
                            digest_size=16).hexdigest())


def model_key(model: Optional[Model]):
    """Content key for a model head (identity for an unknown head type)."""
    if model is None:
        return None
    if isinstance(model, LinearOperator):
        return ("linear", _array_key(model.L),
                None if model.bias is None else _array_key(model.bias))
    if isinstance(model, DecisionTreeGEMM):
        return ("tree", _array_key(model.F), _array_key(model.v),
                _array_key(model.H), _array_key(model.h))
    return ("id", type(model).__name__, id(model))


def _digest(a) -> str:
    arr = _host(a)
    return hashlib.blake2b(
        np.ascontiguousarray(arr).tobytes()
        + repr((arr.shape, arr.dtype.str)).encode(),
        digest_size=16).hexdigest()


# --------------------------------------------------------------------------
# Arm-level artifact keys
# --------------------------------------------------------------------------
def pkindex_key(table: str, pk_col: str) -> tuple:
    return ("pkindex", table, pk_col)


def join_key(fact: str, fk_col: str, table: str, pk_col: str) -> tuple:
    return ("join", fact, fk_col, table, pk_col)


def dmask_key(table: str, preds: tuple) -> tuple:
    return ("dmask", table, tuple(preds))


def features_key(table: str, feature_cols: Sequence[str]) -> tuple:
    return ("features", table, tuple(feature_cols))


def partial_key(table: str, feature_cols: Sequence[str], model: Model,
                lo: int, hi: int, j: int = 0) -> tuple:
    """Content key of one arm's Eq. 1/3 prefused partial.

    Linear heads: the partial is ``B_j M_j L[lo:hi]``, so only the slice's
    content keys it — two queries placing the same arm at different
    feature offsets still share when their L rows there agree.  A bias is
    carried by arm 0's partial, so that arm's key pins the bias bytes too.
    Tree heads also depend on the node-ownership mask, which reads the
    argmax over the full F, so the key pins (lo, hi) and all of F/v/H.
    """
    if isinstance(model, LinearOperator):
        bias = ()
        if j == 0 and model.bias is not None:
            bias = (("bias", _digest(model.bias)),)
        return ("partial", "linear", table, tuple(feature_cols),
                _digest(_host(model.L)[lo:hi])) + bias
    return ("partial", "tree", table, tuple(feature_cols), int(lo), int(hi),
            _digest(model.F), _digest(model.v), _digest(model.H))


def arm_keys(q: PredictiveQuery) -> Tuple[Tuple[tuple, ...], ...]:
    """Per-arm artifact key sets — the common-subplan signature of ``q``:
    PK index, FK join probe, predicate mask (when predicated) or collapsed
    chain (when chained) and model partial (when ``q`` has a model).  Two
    queries share offline work exactly where these sets intersect."""
    slices = [(0, 0)] * len(q.arms)
    if q.model is not None:
        off = 0
        slices = []
        for arm in q.arms:
            slices.append((off, off + arm.feature_width))
            off += arm.feature_width
    out = []
    for j, (arm, (lo, hi)) in enumerate(zip(q.arms, slices)):
        # Chained arms index and probe against the real head table (shared
        # with flat arms over the same head); the chain collapse and its
        # partial are keyed by the full chain content.
        keys = [pkindex_key(arm.table, arm.pk_col),
                join_key(q.fact, arm.fk_col, arm.table, arm.pk_col)]
        if arm.links:
            keys.append(chain_key(arm))
        elif arm.preds:
            keys.append(dmask_key(arm.table, arm.preds))
        if q.model is not None:
            if arm.links:
                keys.append(partial_key(virtual_name(arm),
                                        qualified_cols(arm), q.model,
                                        lo, hi, j) + (chain_key(arm),))
            else:
                keys.append(partial_key(arm.table, arm.feature_cols,
                                        q.model, lo, hi, j))
        out.append(tuple(keys))
    return tuple(out)


def _mask_rows(dim: Table, preds, ids: torch.Tensor) -> torch.Tensor:
    """The dimension-predicate mask evaluated on just the rows ``ids``.

    The same math as a cold ``valid_mask() & preds`` fold at those rows:
    the pool's scatter refresh and the serving runtime's delta refresh use
    it, and both must agree with a cold build bit for bit.
    """
    sub = Table(dim.name, dim.columns, dim.matrix[ids],
                {c: v[ids] for c, v in dim.keys.items()},
                int(ids.shape[0]))
    # The sub-table is all live by construction (nvalid = len(ids), no
    # tombstones), so fold the parent's liveness at these rows explicitly.
    m = dim.valid_mask()[ids]
    for p in preds:
        m = m & p.mask(sub)
    return m


# --------------------------------------------------------------------------
# The pool
# --------------------------------------------------------------------------
@dataclasses.dataclass
class _PoolEntry:
    """One shared artifact: value + versions + refcount + update counter."""

    key: tuple
    kind: str
    value: object
    versions: Dict[str, int]     # gating tables → catalog version at build
    spec: Dict                   # kind-specific refresh context
    refcount: int = 0
    updates: int = 0             # delta/cold refreshes applied

    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in _entry_arrays(self.value))


def _entry_arrays(value) -> List[torch.Tensor]:
    if isinstance(value, PKIndex):
        return [value.sorted_pk, value.order]
    if isinstance(value, CollapsedChain):
        arrs = [value.table.matrix, value.dmask]
        for _name, ptr, found in value.link_ptrs:
            arrs.extend([ptr, found])
        for h in value.hops:
            if h is not None:
                arrs.extend([h.ptr, h.found])
        return arrs
    if isinstance(value, tuple):
        return [v for v in value if v is not None]
    return [value] if value is not None else []


class ArtifactPool:
    """Reference-counted shared quasi-static artifacts for one catalog.

    ``acquire_*`` methods return ``(value, key)`` and take a reference;
    :meth:`get` is the non-refcounting fetch the plans' refresh paths use
    (a plan already holds its reference).  Both refresh a stale entry
    first, exactly once per catalog version change however many plans
    reference it.  :meth:`release` drops references and evicts entries
    nothing points at.
    """

    def __init__(self, catalog):
        self.catalog: Catalog = Catalog.wrap(catalog)
        self._entries: Dict[tuple, _PoolEntry] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- core entry lifecycle ------------------------------------------------
    def _fresh(self, key: tuple, kind: str, tables: Tuple[str, ...],
               build: Callable[[], object], spec: Dict) -> _PoolEntry:
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            entry = _PoolEntry(
                key=key, kind=kind, value=build(),
                versions={n: self.catalog.version(n) for n in tables},
                spec=dict(spec))
            self._entries[key] = entry
        else:
            self.hits += 1
            self._refresh_entry(entry)
        return entry

    def get(self, key: tuple):
        """The entry's current value, refreshed if stale (no refcount)."""
        entry = self._entries[key]
        self._refresh_entry(entry)
        return entry.value

    def release(self, keys: Sequence[tuple]) -> int:
        """Drop one reference per key; evict entries reaching zero.

        ``keys`` is the exact multiset the owner acquired (duplicates drop
        several references).  Returns the number of evictions.
        """
        evicted = 0
        work = list(keys)
        while work:
            key = work.pop()
            entry = self._entries.get(key)
            if entry is None:
                continue
            entry.refcount -= 1
            if entry.refcount <= 0:
                del self._entries[key]
                evicted += 1
                # A chain holds one reference on each pooled hop probe;
                # evicting the chain drops those too.
                work.extend(entry.spec.get("hops", ()))
        self.evictions += evicted
        return evicted

    def refcount(self, key: tuple) -> int:
        entry = self._entries.get(key)
        return entry.refcount if entry is not None else 0

    def update_count(self, key: tuple) -> int:
        entry = self._entries.get(key)
        return entry.updates if entry is not None else 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: tuple) -> bool:
        return key in self._entries

    def keys(self):
        return self._entries.keys()

    def stats(self) -> Dict:
        """Pool-wide counters: entries/hits/misses/evictions/updates/bytes
        plus a per-kind entry count."""
        by_kind: Dict[str, int] = collections.Counter(
            e.kind for e in self._entries.values())
        return {
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "updates": sum(e.updates for e in self._entries.values()),
            "bytes": sum(e.nbytes() for e in self._entries.values()),
            "by_kind": dict(by_kind),
        }

    def sharing_hint(self, fact: str, arms) -> float:
        """How many plans already share ``(fact, arms)``'s join artifacts.

        Feeds the planner's prefuse amortization: a partial referenced by N
        plans amortizes its build over N times the batches.  1.0 when
        nothing is shared yet.
        """
        counts = [self._entries[k].refcount for arm in arms
                  for k in (join_key(fact, arm.fk_col, arm.table,
                                     arm.pk_col),)
                  if k in self._entries]
        return 1.0 + float(max(counts)) if counts else 1.0

    # -- acquire: PK index ---------------------------------------------------
    def _pkindex_entry(self, table: str, pk_col: str) -> _PoolEntry:
        return self._fresh(
            pkindex_key(table, pk_col), "pkindex", (table,),
            lambda: pk_index(self.catalog[table].key(pk_col)),
            {"table": table, "pk_col": pk_col})

    def acquire_pkindex(self, table: str, pk_col: str
                        ) -> Tuple[PKIndex, tuple]:
        entry = self._pkindex_entry(table, pk_col)
        entry.refcount += 1
        return entry.value, entry.key

    # -- acquire: FK join probe ---------------------------------------------
    def acquire_join(self, fact: str, fk_col: str, table: str, pk_col: str
                     ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], tuple]:
        """The fact-sized ``(ptr, found)`` probe of one arm — the dominant
        shared artifact (and offline cost) across the registry."""
        def build():
            idx = self._pkindex_entry(table, pk_col).value
            fj = idx.probe(self.catalog[fact].key(fk_col))
            return (fj.ptr, fj.found)
        entry = self._fresh(
            join_key(fact, fk_col, table, pk_col), "join", (fact, table),
            build, {"fact": fact, "fk_col": fk_col, "table": table,
                    "pk_col": pk_col})
        entry.refcount += 1
        return entry.value, entry.key

    # -- acquire: dimension predicate mask ----------------------------------
    def _build_dmask(self, table: str, preds) -> torch.Tensor:
        dim = self.catalog[table]
        m = dim.valid_mask()
        for p in preds:
            m = m & p.mask(dim)
        return m

    def acquire_dmask(self, table: str, preds
                      ) -> Tuple[torch.Tensor, tuple]:
        """Row liveness ∧ dimension predicates, in dimension-row order.

        ``Pred.mask`` folds the validity itself, so this value is
        boolean-identical on the compile path (which ANDs bare predicate
        masks) and the serving path (which ANDs validity explicitly).
        """
        preds = tuple(preds)
        entry = self._fresh(
            dmask_key(table, preds), "dmask", (table,),
            lambda: self._build_dmask(table, preds),
            {"table": table, "preds": preds})
        entry.refcount += 1
        return entry.value, entry.key

    # -- acquire: projected feature tables (nonfused serving) ----------------
    def _build_features(self, table: str, feature_cols) -> torch.Tensor:
        dim = self.catalog[table]
        return dim.matrix @ mapping_matrix(dim.columns, feature_cols,
                                           device=dim.device)

    def acquire_features(self, table: str, feature_cols: Sequence[str]
                         ) -> Tuple[torch.Tensor, tuple]:
        feature_cols = tuple(feature_cols)
        entry = self._fresh(
            features_key(table, feature_cols), "features", (table,),
            lambda: self._build_features(table, feature_cols),
            {"table": table, "feature_cols": feature_cols})
        entry.refcount += 1
        return entry.value, entry.key

    # -- acquire: collapsed snowflake chains ----------------------------------
    def acquire_chain(self, arm: ArmSpec, *, keep_hops: int = 0
                      ) -> Tuple[CollapsedChain, tuple]:
        """The collapsed chain of one multi-hop arm (see ``snowflake``).

        Keyed by the full chain content, gated on every chain table's
        version.  ``keep_hops`` is a refresh-speed hint that never changes
        the collapsed values, so plans that disagree on it share one entry
        (the first build's).

        Each hop's parent→link probe is itself pooled (the ``join`` kind,
        parent table on the probing side): two chains sharing a prefix, or
        a flat arm probing the same link, reuse one probe.  The chain holds
        a reference on each hop key (``spec["hops"]``), which
        :meth:`release` drops when the chain is evicted.
        """
        key = chain_key(arm)
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            hop_keys: list = []

            def hop_source(parent, lk):
                _, ik = self.acquire_pkindex(lk.table, lk.pk_col)
                (ptr, found), k = self.acquire_join(
                    parent, lk.fk_col, lk.table, lk.pk_col)
                hop_keys.extend((k, ik))
                return FactoredJoin(ptr, found)

            value = resolve_chain(self.catalog, arm, keep_hops=keep_hops,
                                  hop_source=hop_source)
            entry = _PoolEntry(
                key=key, kind="chain", value=value,
                versions={n: self.catalog.version(n)
                          for n in chain_tables(arm)},
                spec={"arm": arm, "keep_hops": keep_hops,
                      "hops": tuple(hop_keys)})
            self._entries[key] = entry
        else:
            self.hits += 1
            self._refresh_entry(entry)
        entry.refcount += 1
        return entry.value, entry.key

    # -- acquire: prefused partials (one prefuse_dims per miss set) ----------
    def acquire_partials(self, dims: Sequence[DimSpec], model: Model,
                         chains: Sequence[Optional[CollapsedChain]] = ()
                         ) -> Tuple[Tuple[torch.Tensor, ...],
                                    Optional[torch.Tensor],
                                    Tuple[tuple, ...]]:
        """Eq. 1/3 partials for a whole arm list: ``(partials, h, keys)``.

        Misses are computed by ONE :func:`prefuse_dims` call over the full
        list — exactly the computation the unpooled compile runs, so hits
        handed back from the pool are bit-identical to what that call
        would have produced for them.

        ``chains`` marks which dims are collapsed snowflake chains
        (parallel to ``dims``; None for flat arms).  A chained partial's
        key carries the chain's content key (the virtual table's name alone
        would alias chains over the same tables with other hop keys), and
        its refresh gates on every chain table.
        """
        chains = tuple(chains) + (None,) * (len(dims) - len(chains))
        slices = _feature_slices(dims)
        keys, arm_specs = [], []
        for j, (d, (lo, hi), cc) in enumerate(zip(dims, slices, chains)):
            k = partial_key(d.dim.name, d.feature_cols, model, lo, hi, j)
            if cc is not None:
                k = k + (chain_key(cc.arm),)
                arm_specs.append(cc.arm)
            else:
                arm_specs.append((d.dim.name, d.fk_col, d.pk_col,
                                  tuple(d.feature_cols)))
            keys.append(k)
        keys, arm_specs = tuple(keys), tuple(arm_specs)
        pre = (prefuse_dims(dims, model)
               if any(k not in self._entries for k in keys) else None)
        parts = []
        for j, (d, key, cc) in enumerate(zip(dims, keys, chains)):
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                gates = (chain_tables(cc.arm) if cc is not None
                         else (d.dim.name,))
                entry = _PoolEntry(
                    key=key, kind="partial", value=pre.partials[j],
                    versions={n: self.catalog.version(n) for n in gates},
                    spec={"arms": arm_specs, "j": j, "model": model})
                self._entries[key] = entry
            else:
                self.hits += 1
                self._refresh_entry(entry)
            entry.refcount += 1
            parts.append(entry.value)
        h = model.h if isinstance(model, DecisionTreeGEMM) else None
        return tuple(parts), h, keys

    # -- lazy, exactly-once refresh ------------------------------------------
    def _refresh_entry(self, entry: _PoolEntry) -> None:
        stale = self.catalog.stale_tables(entry.versions)
        if not stale:
            return
        refresh = getattr(self, f"_refresh_{entry.kind}")
        try:
            deltas = {n: self.catalog.deltas_since(n, entry.versions[n])
                      for n in stale}
            if any(d and changed_spans(d).grew for d in deltas.values()):
                raise CatalogHistoryError("capacity growth: cold rebuild")
            refresh(entry, deltas)
        except CatalogHistoryError:
            # Staler than the delta log, or shapes changed: rebuild cold.
            # Every referencing plan recompiles on growth before reading.
            entry.value = getattr(self, f"_rebuild_{entry.kind}")(entry)
        entry.versions = {n: self.catalog.version(n)
                          for n in entry.versions}
        entry.updates += 1

    @staticmethod
    def _touched_ids(deltas, device) -> Optional[torch.Tensor]:
        """Appended, updated and deleted row ids, sorted and distinct, as
        an int64 tensor on ``device`` (None when no row changed).  The
        reference pads this list to a power of two so its jitted scatter
        compiles once per size class; an eager scatter needs no padding."""
        span, dirty, _, deleted = changed_spans(deltas)
        ids = [torch.as_tensor(dirty + deleted, dtype=torch.int64,
                               device=device)]
        if span is not None:
            ids.append(torch.arange(span[0], span[1], device=device))
        ids = torch.unique(torch.cat(ids))
        return ids if ids.numel() else None

    def _rebuild_pkindex(self, entry):
        s = entry.spec
        return pk_index(self.catalog[s["table"]].key(s["pk_col"]))

    def _refresh_pkindex(self, entry, deltas):
        s = entry.spec
        dim = self.catalog[s["table"]]
        span = changed_spans(deltas[s["table"]]).span
        if span is not None:
            lo, hi = span
            entry.value = entry.value.extend(
                dim.key(s["pk_col"])[lo:hi],
                torch.arange(lo, hi, device=dim.device))

    def _rebuild_join(self, entry):
        s = entry.spec
        idx = self._pkindex_entry(s["table"], s["pk_col"]).value
        fj = idx.probe(self.catalog[s["fact"]].key(s["fk_col"]))
        return (fj.ptr, fj.found)

    def _refresh_join(self, entry, deltas):
        # The two-sided delta probe CompiledQuery._refresh_delta runs:
        # appended dimension PKs are probed as a sorted block against the
        # whole FK column; appended fact rows probe the (already extended)
        # full index.  Updated non-key rows never move pointers.
        s = entry.spec
        cat = self.catalog
        fact, dim = cat[s["fact"]], cat[s["table"]]
        ptr, found = entry.value
        dspan = (changed_spans(deltas[s["table"]]).span
                 if s["table"] in deltas else None)
        fspan = (changed_spans(deltas[s["fact"]]).span
                 if s["fact"] in deltas else None)
        if dspan is not None:
            lo, hi = dspan
            nk = dim.key(s["pk_col"])[lo:hi]
            order = torch.argsort(nk, stable=True)
            snk = nk[order]
            srow = (order + lo).to(torch.int32)
            fk = fact.key(s["fk_col"])
            posc = torch.searchsorted(snk, fk).clamp(max=hi - lo - 1)
            hit = (snk[posc] == fk) & (fk != PAD_KEY)
            ptr = torch.where(hit, srow[posc], ptr)
            found = found | hit
        if fspan is not None:
            flo, fhi = fspan
            idx = self._pkindex_entry(s["table"], s["pk_col"]).value
            fj = idx.probe(fact.key(s["fk_col"])[flo:fhi])
            if dspan is None:     # new tensors: the old value stays as it is
                ptr, found = ptr.clone(), found.clone()
            ptr[flo:fhi] = fj.ptr
            found[flo:fhi] = fj.found
        entry.value = (ptr, found)

    def _rebuild_dmask(self, entry):
        s = entry.spec
        return self._build_dmask(s["table"], s["preds"])

    def _refresh_dmask(self, entry, deltas):
        s = entry.spec
        dim = self.catalog[s["table"]]
        ids = self._touched_ids(deltas[s["table"]], dim.device)
        if ids is not None:
            value = entry.value.clone()
            value[ids] = _mask_rows(dim, s["preds"], ids)
            entry.value = value

    def _rebuild_features(self, entry):
        s = entry.spec
        return self._build_features(s["table"], s["feature_cols"])

    def _refresh_features(self, entry, deltas):
        s = entry.spec
        dim = self.catalog[s["table"]]
        ids = self._touched_ids(deltas[s["table"]], dim.device)
        if ids is not None:
            m = mapping_matrix(dim.columns, s["feature_cols"],
                               device=dim.device)
            value = entry.value.clone()
            value[ids] = dim.matrix[ids] @ m
            entry.value = value

    def _hop_source_for(self, entry):
        """A ``resolve_chain`` hop source reading this chain's pooled hop
        probes (each refreshed at most once, through :meth:`get`)."""
        def hop_source(parent, lk):
            key = join_key(parent, lk.fk_col, lk.table, lk.pk_col)
            if key not in self._entries:
                return None
            ptr, found = self.get(key)
            return FactoredJoin(ptr, found)
        return hop_source

    def _rebuild_chain(self, entry):
        s = entry.spec
        return resolve_chain(self.catalog, s["arm"],
                             keep_hops=s["keep_hops"],
                             hop_source=self._hop_source_for(entry))

    def _refresh_chain(self, entry, deltas):
        # Every hop is a pooled probe, refreshed once for all its holders;
        # the composition and gathers rerun (dimension-sized), so the new
        # value is a cold collapse's bit for bit.
        entry.value = self._rebuild_chain(entry)

    def _partial_dims(self, entry, chains: Optional[Dict[
            int, CollapsedChain]] = None) -> Tuple[DimSpec, ...]:
        # A chained arm's spec is the ArmSpec itself; it resolves through
        # the (possibly freshly re-collapsed) chain's virtual table.
        dims = []
        for i, a in enumerate(entry.spec["arms"]):
            if isinstance(a, ArmSpec):
                cc = (chains or {}).get(i) or resolve_chain(self.catalog, a)
                dims.append(DimSpec(cc.table, a.fk_col, a.pk_col,
                                    tuple(cc.table.columns)))
            else:
                t, fk, pk, fcols = a
                dims.append(DimSpec(self.catalog[t], fk, pk, fcols))
        return tuple(dims)

    def _rebuild_partial(self, entry):
        dims = self._partial_dims(entry)
        return prefuse_dims(dims, entry.spec["model"]).partials[
            entry.spec["j"]]

    def _refresh_partial(self, entry, deltas):
        s = entry.spec
        a = s["arms"][s["j"]]
        if isinstance(a, ArmSpec):
            # Chained partial: re-collapse (dimension-sized gathers), then
            # recompute exactly the head rows whose virtual-matrix rows may
            # differ — the dirty set the unpooled refresh computes.
            cc = resolve_chain(self.catalog, a)
            dims = self._partial_dims(entry, chains={s["j"]: cc})
            dev = cc.dmask.device
            touched = {}
            for name, d in deltas.items():
                t = self._touched_ids(d, dev)
                if t is not None:
                    touched[name] = t
            ids = chain_dirty_heads(cc, touched)
            ids = None if ids is None else ids.to(torch.int64)
        else:
            dims = self._partial_dims(entry)
            dim = dims[s["j"]].dim
            ids = self._touched_ids(deltas[dim.name], dim.device)
        if ids is not None:
            value = entry.value.clone()
            value[ids] = prefuse_rows(dims, s["model"], s["j"], ids)
            entry.value = value


# --------------------------------------------------------------------------
# Stacked multi-query execution
# --------------------------------------------------------------------------
def _leaves(x, path: str = ""):
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k], f"{path}/{k}")
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, x


def state_signature(state) -> tuple:
    """Structure + per-leaf (shape, dtype) of a program state."""
    return tuple((path, None if x is None
                  else (tuple(x.shape), str(x.dtype)))
                 for path, x in _leaves(state))


def stack_key(compiled) -> Optional[tuple]:
    """The structural compatibility class of one compiled plan, or ``None``
    when the plan cannot stack (no online program; mesh-sharded;
    select-compacted: such a plan closes over a per-plan fact skeleton
    whose key columns differ between members; or streamed).

    Two plans with equal keys run the *same* online program over different
    states: predicates and group assignments live in the state
    (``valid``/``gid``), so e.g. the four SSB flights each collapse their
    three variants into one class.  Everything the program bakes in —
    backends, aggregate list, group dimension, model content, state
    signature — is part of the key.
    """
    q = compiled.query
    if (getattr(compiled, "_online_fn", None) is None
            or getattr(compiled, "_sp", None) is not None
            or compiled._opts.get("select_capacity") is not None):
        return None
    if getattr(compiled, "_stream", None) is not None:
        # A streaming plan runs chunk by chunk with a carried accumulator:
        # there is no whole-fact state to stack.
        return None
    return ("stack", q.fact,
            tuple((a.table, a.fk_col, a.pk_col, a.feature_cols)
                  for a in q.arms),
            q.aggregates,
            q.num_groups if q.group_keys else None,
            model_key(q.model),
            compiled.backend, compiled.join_backend, compiled.agg_backend,
            compiled.serve_backend, state_signature(
                {k: v for k, v in compiled._state.items() if k != "sharded"}))


def make_stacked_runner(online_fn) -> Callable:
    """One call running N structurally compatible plans.

    ``online_fn`` is a plan's
    :class:`~repro_torch.core.query.compile.OnlineProgram`; the runner
    takes :func:`stack_states` of the members' states and returns each
    aggregate stacked along a leading query axis, as the reference's
    ``jax.vmap`` does.  The model head runs through ``predict_class``: each
    kernel launches once for the whole class, over the members' rows side
    by side, or once over the rows the members share (see
    ``OnlineProgram``).  The group-by then reads each member's slice of
    those predictions with that member's validity and group ids — the same
    operations ``run()`` applies, so each member's result is its
    ``run()``'s bit for bit.
    """
    def run(states: Sequence[Dict]) -> Dict[str, torch.Tensor]:
        preds = (online_fn.predict_class(states)
                 if online_fn.predict is not None else [None] * len(states))
        outs = [online_fn.aggregate(s, p) for s, p in zip(states, preds)]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    return run


def stack_states(states: Sequence[Dict]) -> List[Dict]:
    """The members' states of one class, in order, as the stacked runner
    takes them.  Unlike the reference's leaf-wise ``jnp.stack``, nothing is
    copied: the members of a session's class share their pooled join
    columns and partials, and the runner's kernels read those once."""
    return list(states)


# --------------------------------------------------------------------------
# Measurement helpers (benches/tests)
# --------------------------------------------------------------------------
def artifact_bytes(plans) -> int:
    """Resident bytes of *derived* quasi-static artifacts, deduplicated.

    Counts pointers, masks, partials and indices — the tensors compilation
    manufactures, a fused-kernel plan's ``(J, n)`` join stack included —
    and excludes source tables (``fact_matrix``/``dim_mats``), which alias
    the catalog whether or not a pool is in play.  Tensors shared between
    plans (the pool's point) count once, by ``id``; an unpooled plan's
    join columns are views of its stack, and count as well.
    """
    seen: Dict[int, int] = {}

    def add(a):
        if a is not None:
            seen[id(a)] = a.numel() * a.element_size()

    for p in plans:
        state = getattr(p, "_state", None)
        if state is not None and "ptrs" in state:      # CompiledQuery
            for k in ("valid", "gid", "h"):
                add(state.get(k))
            for k in ("ptrs", "founds", "partials", "stacked_joins"):
                for a in (state.get(k) or ()):
                    add(a)
            for idx in getattr(p, "_indices", ()):
                add(idx.sorted_pk)
                add(idx.order)
        else:                                           # ServingRuntime
            add(getattr(p, "_h", None))
            for a in getattr(p, "_arms", ()):
                if a.index is not None:     # None on the mesh path
                    add(a.index.sorted_pk)
                    add(a.index.order)
                add(a.dmask)
                add(a.table)
    return sum(seen.values())
