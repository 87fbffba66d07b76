"""Snowflake chains: multi-hop arms collapsed to head-granularity virtual
dimensions (port of ``repro.core.query.snowflake``).

The factored-join form (Eq. 1) composes associatively: if the fact resolves
into a dimension ``D`` through ``FactoredJoin(ptr_f, found_f)`` and ``D``
resolves into a sub-dimension ``S`` through ``FactoredJoin(ptr_d,
found_d)``, then ``ptr_f→S = ptr_d[ptr_f]`` with ``found = found_f ∧
found_d[ptr_f]`` is exactly the pointer array of the flat ``fact ⋈ S`` join.
This module collapses a multi-hop chain (``ArmSpec.links``) into one
head-granularity virtual dimension offline:

- every hop is probed once at the **parent's** granularity (dimension-sized,
  never fact-sized), then composed top-down to head granularity;
- sub-dimension feature columns are gathered through the composed pointers
  into one virtual feature matrix (qualified ``table.col`` column names);
- sub-dimension predicates and row liveness fold into one head-granularity
  validity vector, as the compiler folds flat dimension predicates into the
  join's validity (§2.2).

The compiler then lowers the chained arm as a flat arm over the virtual
table: the same Eq. 1 prefusion and online program, bit for bit the chain
materialized as one flat pre-joined dimension (:func:`materialize_chains`
builds that baseline for tests and the smoke run).  Every gather and fold
here is a tensor operation on the tables' device.

Where along the chain to *materialize* is a planner decision
(:func:`~.planner.plan_chain_materialization`): caching the first ``k`` hop
probes (``CollapsedChain.hops``) costs dimension-sized memory but lets
:func:`refresh_chain` recompose the chain after an append without
re-probing unchanged hops.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Optional, Tuple

import torch

from ..laq.join import FactoredJoin, join_factored
from ..laq.table import Table
from .ir import ArmSpec, PredictiveQuery


def virtual_name(arm: ArmSpec) -> str:
    """The collapsed chain's catalog-overlay name: ``head->link->...``."""
    return "->".join([arm.table, *(lk.table for lk in arm.links)])


def qualified_cols(arm: ArmSpec) -> Tuple[str, ...]:
    """Virtual feature columns, ``table.col``-qualified (unique across hops,
    since the IR rejects duplicate table aliases)."""
    cols = [f"{arm.table}.{c}" for c in arm.feature_cols]
    for lk in arm.links:
        cols.extend(f"{lk.table}.{c}" for c in lk.feature_cols)
    return tuple(cols)


def flat_arm(arm: ArmSpec) -> ArmSpec:
    """The flat arm the compiler lowers in place of a chained one.

    Predicates are dropped on purpose: head and link predicates are already
    folded into the collapsed chain's validity vector, which the compiler
    passes in as the arm's dimension mask.
    """
    if not arm.links:
        return arm
    return ArmSpec(virtual_name(arm), arm.fk_col, arm.pk_col,
                   qualified_cols(arm))


def link_parents(arm: ArmSpec) -> Tuple[str, ...]:
    """Each link's resolved parent table (``parent=None`` → previous hop)."""
    parents, prev = [], arm.table
    for lk in arm.links:
        parents.append(lk.parent if lk.parent is not None else prev)
        prev = lk.table
    return tuple(parents)


def chain_tables(arm: ArmSpec) -> Tuple[str, ...]:
    """Real catalog tables a (possibly chained) arm reads: head + links."""
    return (arm.table, *(lk.table for lk in arm.links))


def participating_tables(q: PredictiveQuery) -> Tuple[str, ...]:
    """Every real table the query reads: fact, heads and chain links."""
    names = {q.fact}
    for a in q.arms:
        names.update(chain_tables(a))
    return tuple(sorted(names))


def chain_key(arm: ArmSpec) -> tuple:
    """Content key for pooled collapsed chains.

    Everything the collapsed value depends on: head table and PK, the
    gathered feature columns, head predicates and the whole link tuple.
    The fact-side ``fk_col`` is left out: two queries joining the same
    chain through different fact FKs share one collapse.
    """
    return ("chain", arm.table, arm.pk_col, arm.feature_cols, arm.preds,
            arm.links)


@dataclasses.dataclass(frozen=True)
class CollapsedChain:
    """One chain, collapsed offline to head granularity.

    ``table`` is the virtual dimension (qualified feature columns, the
    head's PK); ``dmask`` the head-granularity validity with every hop's
    ``found``, liveness and predicates folded in; ``link_ptrs`` maps each
    link table to its head-granularity composed pointers and liveness
    (group keys on sub-dimension columns gather through these); ``hops``
    caches the first ``k`` parent-granularity probes for
    :func:`refresh_chain` (``None`` entries are re-probed on refresh).
    """

    arm: ArmSpec
    table: Table
    dmask: torch.Tensor
    link_ptrs: Tuple[Tuple[str, torch.Tensor, torch.Tensor], ...]
    hops: Tuple[Optional[FactoredJoin], ...]

    @property
    def cached_hops(self) -> int:
        return sum(1 for h in self.hops if h is not None)


def resolve_chain(catalog: Mapping[str, Table], arm: ArmSpec, *,
                  keep_hops: int = 0,
                  reuse: Optional[CollapsedChain] = None,
                  stale: Iterable[str] = (),
                  hop_source=None) -> CollapsedChain:
    """Collapse one chained arm to a head-granularity virtual dimension.

    ``keep_hops`` caches the first ``k`` parent-granularity probes on the
    result.  ``reuse`` + ``stale`` is the refresh path: hops cached on the
    previous collapse whose parent and link tables are not stale are
    reused instead of re-probed; the composition and feature gathers always
    rerun, so the result equals a cold collapse bit for bit.

    ``hop_source(parent, link) -> FactoredJoin | None`` supplies hop probes
    from outside: the :class:`~.multiquery.ArtifactPool` passes one, so two
    chains threading the same hop share one probe.  A ``None`` return falls
    through to ``reuse`` / ``join_factored``; a supplied probe must equal
    ``join_factored(catalog[parent].key(link.fk_col),
    catalog[link.table].key(link.pk_col))``.
    """
    head = catalog[arm.table]
    stale = set(stale)
    # None: the head itself (links hanging off it use their probe as is).
    to_head: Dict[str, Optional[Tuple[torch.Tensor, torch.Tensor]]]
    to_head = {arm.table: None}
    dmask = head.valid_mask()
    for p in arm.preds:
        dmask = dmask & p.mask(head)
    feats = [head.col(c) for c in arm.feature_cols]
    link_ptrs = []
    hops = []
    for i, (lk, parent) in enumerate(zip(arm.links, link_parents(arm))):
        fj = None
        if hop_source is not None:
            fj = hop_source(parent, lk)
        if (fj is None and reuse is not None and i < len(reuse.hops)
                and reuse.hops[i] is not None
                and parent not in stale and lk.table not in stale):
            fj = reuse.hops[i]
        if fj is None:
            fj = join_factored(catalog[parent].key(lk.fk_col),
                               catalog[lk.table].key(lk.pk_col))
        hops.append(fj if i < keep_hops else None)
        comp = to_head[parent]
        if comp is None:
            ptr_h, found_h = fj.ptr, fj.found
        else:
            p_ptr, p_found = comp
            # Associative composition: head→parent pointers chase into the
            # parent→link probe; a miss anywhere along the path is a miss.
            ptr_h = fj.ptr[p_ptr]
            found_h = p_found & fj.found[p_ptr]
        to_head[lk.table] = (ptr_h, found_h)
        link = catalog[lk.table]
        ok = link.valid_mask()
        for p in lk.preds:
            ok = ok & p.mask(link)
        dmask = dmask & found_h & ok[ptr_h]
        # Gathered features are multiplied by the hop's liveness, so misses
        # are zero (the row is invalid either way, but the virtual matrix
        # stays deterministic for delta comparisons).
        zero = found_h.to(torch.float32)
        for c in lk.feature_cols:
            feats.append(link.col(c)[ptr_h] * zero)
        link_ptrs.append((lk.table, ptr_h, found_h))
    cols = qualified_cols(arm)
    matrix = (torch.stack(feats, dim=1).to(torch.float32) if feats
              else torch.zeros((head.capacity, 0), dtype=torch.float32,
                               device=head.device))
    virtual = Table(virtual_name(arm), cols, matrix,
                    {arm.pk_col: head.key(arm.pk_col)}, head.nvalid)
    return CollapsedChain(arm, virtual, dmask, tuple(link_ptrs), tuple(hops))


def refresh_chain(catalog: Mapping[str, Table], old: CollapsedChain,
                  stale: Iterable[str]) -> CollapsedChain:
    """Re-collapse after catalog deltas, reusing unchanged cached hops."""
    return resolve_chain(catalog, old.arm, keep_hops=old.cached_hops,
                         reuse=old, stale=stale)


def chain_dirty_heads(cc: CollapsedChain,
                      touched: Mapping[str, torch.Tensor]
                      ) -> Optional[torch.Tensor]:
    """Head rows whose virtual matrix rows may differ after the deltas.

    ``touched`` maps real table names to appended/updated row ids (any
    integer sequence or tensor); ``cc`` must be the *new* (re-collapsed)
    chain, so freshly found hops resolve into the appended link rows and
    land in the dirty set.  Returns the sorted distinct head row ids as an
    int32 tensor on the chain's device, or None when nothing in the chain
    was touched.  The test runs on the device (``torch.isin`` over the
    head-sized pointers).
    """
    dev = cc.dmask.device

    def ids_of(name):
        return torch.as_tensor(touched.get(name, ()),
                               dtype=torch.int64).reshape(-1).to(dev)

    ids = [ids_of(cc.arm.table)]
    for name, ptr, found in cc.link_ptrs:
        t = ids_of(name)
        if t.numel():
            hit = torch.isin(ptr.to(torch.int64), t) & found
            ids.append(torch.nonzero(hit).flatten())
    ids = torch.unique(torch.cat(ids))
    if not ids.numel():
        return None
    return ids.to(torch.int32)


def materialize_chains(catalog: Mapping[str, Table], q: PredictiveQuery
                       ) -> Tuple[Dict[str, Table], PredictiveQuery]:
    """The flat-star baseline: each chain as one real pre-joined dimension.

    Returns ``(tables, flat_q)``: one materialized dimension per chained
    arm, and ``flat_q`` joining them as ordinary flat arms.  Rows the
    chain's validity excludes are re-keyed to unique negative sentinels, so
    the flat probe misses exactly where the collapsed path's ``found ∧
    dmask[ptr]`` fold is False and the two lowerings are bit-exact (PKs
    must be non-negative, as ``Table.from_columns`` keys and the workload
    generator's are).

    Group keys on chain tables survive: each group-key column of the head
    or a link is gathered through the composed pointers into a qualified
    ``table.col`` key column of the flat dimension, and ``flat_q``'s group
    keys are rewritten to name it.
    """
    tables: Dict[str, Table] = {}
    arms = []
    group_keys = list(q.group_keys)
    for arm in q.arms:
        if not arm.links:
            arms.append(arm)
            continue
        cc = resolve_chain(catalog, arm)
        pk = catalog[arm.table].key(arm.pk_col)
        dm = cc.dmask
        if bool((pk[dm] < 0).any()):
            raise ValueError(
                f"materialize_chains on arm {arm.table!r} requires "
                "non-negative PKs (negative ids are the re-key sentinels)")
        ids = torch.arange(pk.shape[0], device=pk.device, dtype=torch.int64)
        newpk = torch.where(dm, pk, (-(ids + 2)).to(pk.dtype))
        keys = {arm.pk_col: newpk}
        # Head granularity is the identity; links gather through the
        # chain's composed head→link pointers.  Misses gather arbitrary
        # rows, but those head rows carry sentinel keys no probe matches.
        ptr_to = {arm.table: None}
        ptr_to.update((name, ptr_h) for name, ptr_h, _f in cc.link_ptrs)
        for gi, gk in enumerate(group_keys):
            if gk.table not in ptr_to:
                continue
            src = catalog[gk.table].key(gk.col)
            ptr_h = ptr_to[gk.table]
            qname = f"{gk.table}.{gk.col}"
            keys[qname] = src if ptr_h is None else src[ptr_h]
            group_keys[gi] = dataclasses.replace(
                gk, table=virtual_name(arm), col=qname)
        flat = Table(cc.table.name, cc.table.columns, cc.table.matrix,
                     keys, cc.table.nvalid)
        tables[flat.name] = flat
        arms.append(flat_arm(arm))
    return tables, dataclasses.replace(q, arms=tuple(arms),
                                       group_keys=tuple(group_keys))
