"""Versioned ``Catalog``: the mutable, versioned data surface (port of
``repro.core.laq.catalog``).

The paper flags dimension-table update rates as the weak point of prefused
evaluation (§4.3): the Eq. 1 partials amortize while the dimension tables
are quasi-static, and not at all if every append forces a rebuild.  So:

* every table carries a **monotone version counter**, bumped by each
  transactional mutation (``append`` / ``update_column`` / ``delete_rows``
  / ``compact``),
* each bump records a :class:`TableDelta` — the appended row span, grown
  capacity, dirtied column/rows or tombstoned rows — so an artifact built
  at version ``v`` asks :meth:`Catalog.deltas_since` what changed and
  applies the delta path instead of rebuilding,
* compiled plans and serving runtimes record :meth:`Catalog.versions`, so a
  stale artifact is detectable.

``Catalog`` implements ``Mapping[str, Table]``; plain mappings are wrapped
**read-only** (:meth:`Catalog.wrap`) — a read-only catalog never changes
version, so artifacts built over it are valid forever.

The catalog's own bookkeeping (versions, the delta log) lives on the host;
the tables' tensors stay on their device, and the uniqueness check of an
append runs there too.
"""
from __future__ import annotations

import dataclasses
from typing import (Dict, Iterator, List, Mapping, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from .domain import DomainCache
from .table import Table, _host


@dataclasses.dataclass(frozen=True)
class TableDelta:
    """One version bump of one table.

    ``kind`` is ``"append"`` (rows ``[lo, hi)`` are new; ``grew`` marks a
    capacity reallocation — a *shape* change downstream compiled programs
    cannot absorb without recompiling), ``"update"`` (``col`` overwritten
    at ``rows``; shapes unchanged), ``"delete"`` (rows tombstoned — a pure
    validity fold, shapes and row placement unchanged; ``rows`` holds the
    ids, or ``[lo, hi)`` a covering span for bulk deletes), or
    ``"compact"`` (tombstones physically reclaimed — row ids *moved*, so
    every pointer-based artifact must rebuild; ``grew`` is set because the
    rebuild contract is identical to a capacity change).
    """

    version: int                 # version this delta produced
    kind: str                    # "append" | "update" | "delete" | "compact"
    lo: int = 0                  # first appended/deleted row (append/delete)
    hi: int = 0                  # one past the last such row (append/delete)
    grew: bool = False           # shape/placement change (append/compact)
    col: Optional[str] = None    # updated column (update)
    rows: Tuple[int, ...] = ()   # dirtied/deleted row ids (update/delete)


class CatalogReadOnlyError(ValueError):
    """Mutation attempted on a read-only (auto-wrapped) catalog."""


class CatalogHistoryError(ValueError):
    """The delta log was compacted past the requested version.

    Raised by :meth:`Catalog.deltas_since` when an artifact asks for
    history older than the bounded log retains; refresh implementations
    treat it as "cannot delta" and fall back to a full rebuild.
    """


class Catalog(Mapping):
    """A versioned ``Mapping[str, Table]`` with transactional mutation.

    ``append``/``update_column`` validate fully before touching state, then
    atomically swap in the new Table, bump the table's version, and log the
    delta — so a raising call leaves the catalog (and every version) exactly
    as it was.  Zero-row mutations are version no-ops (nothing changed,
    nothing to refresh).  ``domain_cache`` optionally receives appended key
    values (``DomainCache.refresh_table``) so cached key domains stay warm.

    The per-table delta log is *bounded* (``MAX_DELTA_LOG`` entries): a
    long-lived streaming catalog stays O(1) in memory, and an artifact
    stale by more than the log's depth gets :class:`CatalogHistoryError`
    from ``deltas_since`` — its refresh falls back to a full rebuild, which
    needs no history.  Updates dirtying more than ``UPDATE_ROWS_MAX`` rows
    are logged as one covering span rather than per-row ids (refresh then
    recomputes the span — a correct over-approximation — instead of the
    catalog pinning huge id tuples forever).
    """

    #: Per-table delta-log depth; older entries compact away (class-level
    #: default, overridable per instance).
    MAX_DELTA_LOG = 256
    #: Updates dirtying more rows than this log a covering span instead.
    UPDATE_ROWS_MAX = 1024

    def __init__(self, tables: Mapping[str, Table], *,
                 read_only: bool = False,
                 domain_cache: Optional[DomainCache] = None):
        for name, t in tables.items():
            if not isinstance(t, Table):
                raise TypeError(f"catalog entry {name!r} is not a Table "
                                f"(got {type(t).__name__})")
        self._tables: Dict[str, Table] = dict(tables)
        self._versions: Dict[str, int] = {n: 0 for n in self._tables}
        self._deltas: Dict[str, List[TableDelta]] = {
            n: [] for n in self._tables}
        self._floor: Dict[str, int] = {n: 0 for n in self._tables}
        self._unique_cols: Dict[str, set] = {n: set() for n in self._tables}
        self.read_only = read_only
        self.domain_cache = domain_cache

    @staticmethod
    def wrap(catalog: "Mapping[str, Table] | Catalog") -> "Catalog":
        """``catalog`` itself if already a Catalog, else a read-only wrap.

        The shim behind ``compile_query``/``compile_serving``: plain
        mappings keep working, they just cannot be mutated (their versions
        are frozen at 0).
        """
        if isinstance(catalog, Catalog):
            return catalog
        return Catalog(catalog, read_only=True)

    # -- Mapping protocol ----------------------------------------------------
    def __getitem__(self, name: str) -> Table:
        return self._tables[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._tables)

    def __len__(self) -> int:
        return len(self._tables)

    def __repr__(self) -> str:
        inner = ", ".join(f"{n}@v{self._versions[n]}"
                          for n in sorted(self._tables))
        ro = ", read-only" if self.read_only else ""
        return f"Catalog({inner}{ro})"

    # -- versions ------------------------------------------------------------
    def version(self, name: str) -> int:
        """The table's monotone version (0 until first mutated)."""
        return self._versions[name]

    def versions(self, names: Optional[Sequence[str]] = None
                 ) -> Tuple[Tuple[str, int], ...]:
        """Sorted ``(name, version)`` pairs — the cache-key fragment."""
        names = sorted(self._tables if names is None else set(names))
        return tuple((n, self._versions[n]) for n in names)

    def stale_tables(self, versions: Mapping[str, int]) -> Tuple[str, ...]:
        """Names in ``versions`` whose current version differs, sorted.

        The staleness probe shared by every derived artifact (compiled
        plans, serving runtimes, pool entries): each records the versions
        it was built against and asks what moved since.
        """
        return tuple(sorted(n for n, v in versions.items()
                            if self._versions[n] != v))

    def deltas_since(self, name: str, version: int) -> Tuple[TableDelta, ...]:
        """Every delta applied to ``name`` after ``version``, in order.

        Raises :class:`CatalogHistoryError` when ``version`` predates the
        bounded log's retention — the caller must rebuild from the current
        tables instead of replaying deltas.
        """
        if version > self._versions[name]:
            raise ValueError(
                f"table {name!r} is at version {self._versions[name]}, "
                f"before the requested {version} — catalogs only move "
                "forward")
        if version < self._floor[name]:
            raise CatalogHistoryError(
                f"delta history of {name!r} was compacted up to version "
                f"{self._floor[name]} (log depth {self.MAX_DELTA_LOG}); "
                f"version {version} is too stale to delta-refresh — "
                "rebuild from the current table")
        return tuple(d for d in self._deltas[name] if d.version > version)

    def snapshot(self, names: Optional[Sequence[str]] = None
                 ) -> Dict[str, Table]:
        """A plain-dict view of (a subset of) the current tables."""
        names = list(self._tables if names is None else names)
        return {n: self._tables[n] for n in names}

    def note_unique(self, name: str, col: str):
        """Declare ``col`` of table ``name`` a unique (primary-key) column.

        The compiler/serving builders call this for every join arm's PK
        column, so by the time data streams in the catalog knows the join
        contract and :meth:`append` can reject a duplicate key *before*
        committing — otherwise the violation would only surface later,
        inside every artifact's refresh (``PKIndex.extend``), with the
        poisoned delta already in the log.
        """
        if name in self._unique_cols and col in self._tables[name].keys:
            self._unique_cols[name].add(col)

    def _check_unique(self, name: str, vals: Dict[str, np.ndarray]):
        table = self._tables[name]
        n = int(table.nvalid)
        for col in sorted(self._unique_cols[name] & set(vals)):
            new = _host(vals[col]).astype(np.int64).reshape(-1)
            if np.unique(new).shape[0] != new.shape[0]:
                raise ValueError(
                    f"append to {name!r}: duplicate values within the "
                    f"appended block of unique key column {col!r}")
            # Tombstoned keys still occupy the PK indices (deletion keeps
            # row placement), so they stay reserved until compact().  The
            # membership test runs on the table's device.
            live = table.key(col)[:n]
            new_t = torch.from_numpy(new).to(device=live.device,
                                             dtype=live.dtype)
            dup = new_t[torch.isin(new_t, live)]
            if dup.numel():
                raise ValueError(
                    f"append to {name!r}: keys {dup[:8].tolist()} already "
                    f"exist in unique key column {col!r} — PK uniqueness "
                    "is required by every join over this table (deleted "
                    "keys stay reserved by their tombstones; compact() "
                    "before re-appending them)")

    # -- transactional mutation ----------------------------------------------
    def _writable(self, what: str):
        if self.read_only:
            raise CatalogReadOnlyError(
                f"cannot {what}: this Catalog is read-only (plain mappings "
                "auto-wrap read-only — build a Catalog({...}) explicitly "
                "for a mutable data surface)")

    def append(self, name: str, rows: Mapping[str, np.ndarray], *,
               capacity: Optional[int] = None) -> int:
        """Append ``rows`` (column name → values) to table ``name``.

        Transactional: all validation (unknown table/columns, ragged
        lengths, capacity) happens before any state changes.  Rows landing
        inside the existing padding keep every array shape — downstream
        artifacts refresh without recompiling; overflowing the capacity
        reallocates geometrically and marks the delta ``grew`` (derived
        artifacts fall back to a recompile).  Returns the new version.
        """
        self._writable(f"append to {name!r}")
        if name not in self._tables:
            raise KeyError(f"unknown table {name!r}; catalog has "
                           f"{sorted(self._tables)}")
        self._check_unique(name, dict(rows))
        old = self._tables[name]
        lo = int(old.nvalid)
        new = old.append_rows(rows, capacity=capacity)
        hi = int(new.nvalid)
        if hi == lo:      # zero-row append: validated, but nothing changed
            return self._versions[name]
        grew = new.capacity != old.capacity
        self._commit(name, new, TableDelta(
            version=self._versions[name] + 1, kind="append",
            lo=lo, hi=hi, grew=grew))
        if self.domain_cache is not None:
            self.domain_cache.refresh_table(
                name, {c: torch.from_numpy(_host(rows[c]).astype(np.int32))
                       for c in old.keys if c in rows})
        return self._versions[name]

    def update_column(self, name: str, col: str, row_ids, values) -> int:
        """Overwrite ``col`` at ``row_ids`` on table ``name``.

        Non-key columns only (key updates would invalidate join indices —
        ``Table.update_column`` raises).  Shapes never change, so derived
        artifacts refresh by recomputing exactly the dirtied rows.  Returns
        the new version.
        """
        self._writable(f"update {name!r}.{col!r}")
        if name not in self._tables:
            raise KeyError(f"unknown table {name!r}; catalog has "
                           f"{sorted(self._tables)}")
        arr = np.asarray(row_ids).reshape(-1)
        if arr.size == 0:  # zero-row update: nothing changed
            self._tables[name].update_column(col, row_ids, values)
            return self._versions[name]
        new = self._tables[name].update_column(col, row_ids, values)
        if arr.size > self.UPDATE_ROWS_MAX:
            # Log a covering span, not a giant id tuple: refresh recomputes
            # the span (correct over-approximation), the log stays small.
            delta = TableDelta(
                version=self._versions[name] + 1, kind="update", col=col,
                lo=int(arr.min()), hi=int(arr.max()) + 1, rows=())
        else:
            delta = TableDelta(
                version=self._versions[name] + 1, kind="update", col=col,
                rows=tuple(int(i) for i in arr))
        self._commit(name, new, delta)
        return self._versions[name]

    def delete_rows(self, name: str, row_ids) -> int:
        """Tombstone ``row_ids`` on table ``name``.  Returns the new version.

        Deletion is a pure validity fold: shapes, row placement and keys
        are unchanged, so derived artifacts absorb it as a shape-preserving
        delta (the deleted rows drop out of every validity/dimension mask
        on refresh).  Already-deleted ids are ignored; a delete that
        removes nothing is a version no-op.  Deleted keys stay reserved
        (tombstones keep their index slots) until :meth:`compact`.
        """
        self._writable(f"delete from {name!r}")
        if name not in self._tables:
            raise KeyError(f"unknown table {name!r}; catalog has "
                           f"{sorted(self._tables)}")
        old = self._tables[name]
        arr = np.unique(np.asarray(row_ids, np.int64).reshape(-1))
        n = int(old.nvalid)
        if arr.size and (arr.min() < 0 or arr.max() >= n):
            raise ValueError(
                f"delete_rows on {name!r}: row ids out of the live "
                f"range [0, {n})")
        if old.deleted is not None and arr.size:
            was = old.deleted[torch.from_numpy(arr).to(old.device)]
            arr = arr[~was.cpu().numpy()]
        if arr.size == 0:   # nothing newly deleted: version no-op
            return self._versions[name]
        new = old.delete_rows(arr)
        if arr.size > self.UPDATE_ROWS_MAX:
            # Covering span, like bulk updates: refresh *recomputes* the
            # span rows' validity from the current table (it never assumes
            # every span row is dead), so over-approximation is correct.
            delta = TableDelta(
                version=self._versions[name] + 1, kind="delete",
                lo=int(arr.min()), hi=int(arr.max()) + 1, rows=())
        else:
            delta = TableDelta(
                version=self._versions[name] + 1, kind="delete",
                rows=tuple(int(i) for i in arr))
        self._commit(name, new, delta)
        return self._versions[name]

    def tombstone_fraction(self, name: str) -> float:
        """Deleted fraction of the table's occupied rows (0.0 when clean)."""
        t = self._tables[name]
        n = int(t.nvalid)
        return t.num_deleted / n if n else 0.0

    def compact(self, name: str, *, threshold: float = 0.25) -> bool:
        """Reclaim tombstones on ``name`` once dense enough to pay for it.

        Below ``threshold`` tombstone density this is a no-op returning
        ``False`` — rebuilding every PK index / join pointer / partial for
        a handful of dead rows costs more than the masked rows do.  Past
        it, live rows pack down (``Table.compacted``), freeing the dead
        keys for re-append, and a ``"compact"`` delta is logged with the
        same rebuild contract as capacity growth (row ids moved: every
        pointer-based artifact must rebuild).  Returns ``True`` iff the
        table was rewritten.
        """
        self._writable(f"compact {name!r}")
        if name not in self._tables:
            raise KeyError(f"unknown table {name!r}; catalog has "
                           f"{sorted(self._tables)}")
        if not 0.0 <= threshold <= 1.0:
            raise ValueError(f"threshold {threshold} outside [0, 1]")
        if self.tombstone_fraction(name) < max(threshold,
                                               np.finfo(float).tiny):
            return False
        new = self._tables[name].compacted()
        self._commit(name, new, TableDelta(
            version=self._versions[name] + 1, kind="compact",
            lo=0, hi=int(new.nvalid), grew=True))
        return True

    def _commit(self, name: str, table: Table, delta: TableDelta):
        self._tables[name] = table
        self._versions[name] = delta.version
        log = self._deltas[name]
        log.append(delta)
        while len(log) > self.MAX_DELTA_LOG:
            self._floor[name] = log.pop(0).version


class ChangedSpans(NamedTuple):
    """:func:`changed_spans`'s fold of one table's pending deltas."""

    span: Optional[Tuple[int, int]]   # union [lo, hi) of appended rows
    dirty: Tuple[int, ...]            # sorted distinct updated row ids
    grew: bool                        # shapes/placement changed: rebuild
    deleted: Tuple[int, ...]          # sorted distinct tombstoned row ids


def changed_spans(deltas: Sequence[TableDelta]) -> ChangedSpans:
    """Fold a delta sequence into ``(append_span, dirty, grew, deleted)``.

    The refresh planner's view of "what happened since I was built":
    ``span`` is the union ``[lo, hi)`` of all appended rows (appends are
    contiguous, so the union is one span), ``dirty`` the sorted distinct
    updated row ids (span-logged bulk updates expand here, at refresh
    time, not in the persistent log), ``grew`` whether any append
    reallocated capacity or a compaction moved row ids — the signal that
    forces the rebuild fallback — and ``deleted`` the sorted distinct
    tombstoned row ids, kept **distinct from updates**: an updated row
    has fresh values to recompute, a deleted row must additionally drop
    out of every validity/dimension mask.  Span-logged bulk deletes
    expand here too; consumers must *recompute* those rows' liveness
    from the current table (the span is a covering over-approximation —
    some rows inside it may still be live).
    """
    lo = hi = None
    dirty = set()
    dead = set()
    grew = False
    for d in deltas:
        if d.kind == "append":
            lo = d.lo if lo is None else min(lo, d.lo)
            hi = d.hi if hi is None else max(hi, d.hi)
            grew = grew or d.grew
        elif d.kind == "compact":
            grew = True
        elif d.kind == "delete":
            dead.update(d.rows if d.rows else range(d.lo, d.hi))
        elif d.rows:
            dirty.update(d.rows)
        elif d.hi > d.lo:        # bulk update, logged as a covering span
            dirty.update(range(d.lo, d.hi))
    span = None if lo is None else (lo, hi)
    return ChangedSpans(span, tuple(sorted(dirty)), grew,
                        tuple(sorted(dead)))


def rebuild_reason(changed: Mapping[str, Sequence[TableDelta]]
                   ) -> Optional[str]:
    """Why pending deltas force a rebuild, or None when a delta refresh can
    absorb them: ``"compaction:<tables> rewrote row ids"`` when a table was
    compacted, else ``"capacity-growth:<tables>"`` when an append grew a
    capacity (tables sorted, comma-joined).  Compaction shares the growth
    contract — row ids moved, so every pointer artifact rebuilds — under a
    reason of its own.  Reads the deltas' ``grew`` flags, which is what
    :func:`changed_spans` folds into its ``grew``, without expanding their
    row spans."""
    grown = sorted(n for n, d in changed.items() if any(t.grew for t in d))
    if not grown:
        return None
    compacted = sorted(n for n, d in changed.items()
                       if any(t.kind == "compact" for t in d))
    if compacted:
        return f"compaction:{','.join(compacted)} rewrote row ids"
    return f"capacity-growth:{','.join(grown)}"
