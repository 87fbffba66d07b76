"""Dynamic-batch serving: compile a query's online phase once, serve any
request batch (port of ``repro.core.query.serving``).

A request is one foreign key per star arm, not a fact row.  The runtime
answers it with the paper's Eq. 1 online phase: per-arm lookups into a
sorted PK index built once (``PKIndex.probe``, the probe compiled queries
use), then Σⱼ Pⱼ[ptrⱼ] gathers into the prefused partials (+ ``== h`` for
trees), or, nonfused, the gathered feature rows through the model head.
Dimension predicates and row liveness fold into each arm's hit mask.

Bucketed padding
----------------
Each batch is padded with ``PAD_KEY`` (which never matches a live PK) up to
the smallest configured bucket that holds it; batches above the top bucket
are served in top-bucket chunks.  Padding runs on the host in numpy, then
the padded ``(J, bucket)`` key block goes to the tables' device in one
copy.  PyTorch runs eagerly, so the reference's one jit trace per bucket
becomes each bucket's first call: it is kept out of the latency percentiles
and recorded as the bucket's ``compile_ms``.

Serve backends
--------------
``"kernel"`` runs the fused gather-sum on ``fused_star_gather`` and
nonfused trees on ``tree_predict``; ``"torch"`` runs the plain tensor code;
``"auto"`` picks the kernel on ``cuda`` where the planner says the shapes
fit.  The two give the same results.

Incremental maintenance
-----------------------
The runtime records the :class:`~repro_torch.core.laq.catalog.Catalog`
versions of its arms' tables.  :meth:`ServingRuntime.refresh` applies
pending dimension appends, updates and deletions by delta — sorted-merge
``PKIndex.extend``, ``prefuse_rows`` over only the changed rows, mask
scatters, all tensor operations on the tables' device — so the buckets
keep their first-call records and ``num_compiles`` does not move.
Capacity growth or compaction rebuilds the state and starts a new compile
generation, with the decision recorded on ``plan.reason``.

Shared artifacts: with ``pool=`` (a ``Session``'s
:class:`~repro_torch.core.query.multiquery.ArtifactPool` over the same
catalog) the runtime acquires its partials or projected feature tables,
predicate masks and PK indices from the pool — the entries compiled plans
over the same arms use — and its delta refresh reads the pool's entries,
which the pool updates once for all holders (``pooled artifacts, 0 new
compiles``).  ``close()`` releases the references.

Snowflake chains: a chained arm serves its collapsed head-granularity
virtual dimension (:mod:`~repro_torch.core.query.snowflake`), whose
columns are the arm's features and whose validity folds every hop; a
mutation of any table along a chain rebuilds the runtime (re-collapsing),
while flat arms keep the delta path.

Meshes: ``compile_serving(..., mesh=...)`` partitions the quasi-static
state over a :class:`~repro_torch.launch.mesh.Mesh`
(:mod:`~repro_torch.core.query.sharding`): large partials row-shard over
the mesh's model axis with per-shard ``PKIndex`` slices, small ones
replicate (``plan_partition_spec``), and the padded key block splits over
the data-parallel axes (buckets round up to multiples of their size).  A
mesh runtime keeps no whole index or table: its delta refresh re-indexes
only the shard blocks that own the changed rows (``extend_sharded_arm``).
It runs the plain gathers (no kernel) and takes nothing from a pool.
"""
from __future__ import annotations

import collections
import dataclasses
import time
import warnings
from typing import Deque, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..fusion.operators import DecisionTreeGEMM
from ..fusion.pipeline import prefuse_dims, prefuse_rows
from ..laq.catalog import (Catalog, CatalogHistoryError, changed_spans,
                           rebuild_reason)
from ..laq.join import FactoredJoin, PKIndex, pk_index
from ..laq.projection import mapping_matrix
from ..laq.star import DimSpec
from ..laq.table import PAD_KEY, Table
from ...launch.mesh import dp_size
from .explain import ExplainReport
from .ir import PredictiveQuery
from .multiquery import _mask_rows
from .planner import (SERVE_BACKENDS, QueryPlan, effective_serve_backend,
                      place_tables, plan_query, resolve_mesh_serve_backend)
from .sharding import (ShardedPrefusedPartials, extend_sharded_arm,
                       make_serving_forward, serving_arm_state,
                       shard_prefused_partials)
from .snowflake import CollapsedChain, chain_tables, resolve_chain

#: Default padding buckets: small interactive batches, mid-size batches, and
#: a bulk bucket that also serves as the chunk size for oversized requests.
DEFAULT_BUCKETS = (8, 64, 512)

#: Per-bucket latency samples kept for the percentile report (a bounded
#: window, so a long-lived runtime's bookkeeping stays O(1) per bucket).
LATENCY_WINDOW = 2048


class SentinelKeyError(ValueError):
    """A request carried a key equal to the padding sentinel ``PAD_KEY``.

    Padded slots are recognized by value — ``PAD_KEY`` never matches a live
    PK — so a real request key equal to the sentinel would silently score
    zero.  ``ServingRuntime._normalize`` rejects such keys instead.
    """


@dataclasses.dataclass(frozen=True)
class _ArmIndex:
    """Per-arm lookup state, built once (the offline phase, per arm).

    ``dmask`` holds the dimension-side predicates and row liveness, folded
    into the lookup's hit mask as the compiler folds them into the join.
    ``table`` is the arm's prefused partial (fused) or its projected
    feature rows (nonfused).  On the mesh path ``index`` and ``table`` are
    None: the placed per-shard state (``ServingRuntime.sharded``) holds
    them.
    """

    fk_col: str
    index: Optional[PKIndex]       # None on the mesh path
    dmask: torch.Tensor            # (r,) bool, in dimension-row order
    table: Optional[torch.Tensor]  # (r, w) float32; None on the mesh path


def _serving_tables(q: PredictiveQuery) -> Tuple[str, ...]:
    """Catalog tables whose versions gate a runtime: heads and links.

    The fact table is absent (requests are FK tuples, never fact rows), but
    every table along a snowflake chain takes part: a sub-dimension append
    changes the collapsed virtual dimension.
    """
    return tuple(sorted({t for a in q.arms for t in chain_tables(a)}))


def _host_keys(col) -> np.ndarray:
    """One request column as a flat int32 numpy array."""
    if isinstance(col, torch.Tensor):
        col = col.detach().cpu().numpy()
    return np.asarray(col, np.int32).reshape(-1)


class ServingRuntime:
    """One compiled predictive pipeline serving arbitrary request batches.

    Built by :func:`compile_serving`; call :meth:`serve` with batches of any
    size.  Serving reads only state built at compile time; the latency
    bookkeeping is unsynchronized.
    """

    def __init__(self, query: PredictiveQuery, plan: QueryPlan, backend: str,
                 serve_backend: str, buckets: Tuple[int, ...],
                 arms: Tuple[_ArmIndex, ...], model,
                 h: Optional[torch.Tensor], sync_stats: bool = True,
                 catalog: Optional[Catalog] = None, pool=None,
                 pool_refs: Optional[Dict] = None,
                 sharded: Optional[ShardedPrefusedPartials] = None,
                 mesh=None, shard_axis: str = "model",
                 shard_threshold_bytes: Optional[int] = None):
        self.query = query
        self.plan = plan
        self.backend = backend                # "fused" | "nonfused"
        self.serve_backend = serve_backend    # "torch" | "kernel"
        self.buckets = buckets
        self._model = model
        self._sync_stats = sync_stats
        self._lat: Dict[int, Deque[float]] = {}
        self._lat_chunked: Deque[float] = collections.deque(
            maxlen=LATENCY_WINDOW)
        # One compile record per generation of the state: ``_compile_s`` is
        # the live generation's {bucket: seconds of its first call} (the
        # counterpart of the reference's per-bucket trace + compile),
        # appended to ``_compile_log`` by ``_install`` so a rebuild
        # archives it instead of overwriting it.
        self._compile_log: List[Dict[int, float]] = []
        self.catalog = catalog
        self.versions: Dict[str, int] = (
            {t: catalog.version(t) for t in _serving_tables(query)}
            if catalog is not None else {})
        # Bounded decision trail: the base plan reason plus the last few
        # refresh lines.
        self._refresh_notes: Deque[str] = collections.deque(maxlen=8)
        # Session-owned ArtifactPool sharing (None when compiled
        # standalone): the keys this runtime holds references to —
        # {"arms": ((pkindex, dmask, features|None) per arm),
        #  "partials": (keys,)} — released by close().  A chained arm's
        # tuple has a fourth key, its collapsed chain's.
        self._pool = pool
        self._pool_refs: Dict = pool_refs or {}
        self._mesh = mesh
        self._shard_axis = shard_axis
        self._shard_threshold_bytes = shard_threshold_bytes
        self._install(arms, h, sharded)

    def _install(self, arms: Tuple[_ArmIndex, ...],
                 h: Optional[torch.Tensor],
                 sharded: Optional[ShardedPrefusedPartials] = None):
        """Bind the state and start a new compile generation (first build,
        or a shape-changing rebuild): every bucket's next call is its first
        again."""
        self._arms = arms
        self._h = h
        self.sharded = sharded
        self._forward_impl = (
            make_serving_forward(sharded, self._model, self.backend)
            if sharded is not None else None)
        # Where request blocks go and outputs land: the tables' device, or
        # the mesh's first position.
        self._device = (sharded.out_device if sharded is not None
                        else arms[0].table.device)
        self._compile_s: Dict[int, float] = {}
        self._compile_log.append(self._compile_s)

    # -- sharding introspection ----------------------------------------------
    @property
    def mesh(self):
        """The serving mesh, or None on the single-device path."""
        return self._mesh

    # -- introspection -------------------------------------------------------
    @property
    def request_keys(self) -> Tuple[str, ...]:
        """FK column names a request must provide, in arm order."""
        return tuple(a.fk_col for a in self._arms)

    @property
    def out_width(self) -> int:
        return self._model.l

    @property
    def num_compiles(self) -> int:
        """Buckets that have had their first call in this generation.

        At most ``len(buckets)`` per generation: a delta ``refresh`` swaps
        same-shape state and adds none; only a shape-changing rebuild
        starts a new generation (the count restarts at 0).
        """
        return len(self._compile_s)

    def jit_cache_size(self) -> Optional[int]:
        """The reference's jit executable cache size; always None here.

        The reference's contract allows None ("if jax hides it").  The port
        runs eagerly and has no executable cache: ``num_compiles`` counts
        the buckets' first calls instead.
        """
        return None

    @property
    def generation(self) -> int:
        """The compile generation (0-based; rebuilds increment it)."""
        return len(self._compile_log) - 1

    def compile_history(self) -> List[Dict[int, float]]:
        """Per-generation ``{bucket: compile_ms}`` records, oldest first.

        A delta refresh keeps the live generation's record (no bucket
        starts over); a rebuild archives it and starts a new one, so the
        first generation's times survive every later rebuild.
        """
        return [{b: s * 1e3 for b, s in gen.items()}
                for gen in self._compile_log]

    def latency_stats(self) -> Dict[object, Dict[str, float]]:
        """Per-bucket steady-state serve latency percentiles (ms).

        Each bucket's first call is kept out of the percentiles and
        reported as ``compile_ms``; a bucket that has only had its first
        call appears with ``count == 0`` and no percentile keys.  Oversized
        batches (``n > buckets[-1]``) are served in top-bucket chunks and
        their wall time is one sample per request under ``"chunked"``, so
        one analytical batch cannot skew the top bucket's percentiles.
        A sample covers the whole ``serve`` call: key checks, padding, the
        copy to the device and the online program.  Samples are wall time
        only with ``sync_stats`` (the default), which synchronizes the
        device before the clock stops.
        """
        out: Dict[object, Dict[str, float]] = {}
        for bucket in sorted(set(self._lat) | set(self._compile_s)):
            ts = self._lat.get(bucket, ())
            out[bucket] = {"count": len(ts)}
            if ts:
                out[bucket].update(self._percentiles(ts))
            if bucket in self._compile_s:
                out[bucket]["compile_ms"] = self._compile_s[bucket] * 1e3
        if self._lat_chunked:
            out["chunked"] = {"count": len(self._lat_chunked),
                              **self._percentiles(self._lat_chunked)}
        return out

    @staticmethod
    def _percentiles(ts) -> Dict[str, float]:
        ms = np.asarray(ts) * 1e3
        return {"p50": float(np.percentile(ms, 50)),
                "p95": float(np.percentile(ms, 95)),
                "p99": float(np.percentile(ms, 99))}

    def _pool_keys(self) -> list:
        """Every pool key this runtime references (with multiplicity)."""
        keys = [k for ref in self._pool_refs.get("arms", ()) for k in ref
                if k is not None]
        keys.extend(self._pool_refs.get("partials", ()))
        return keys

    def explain(self) -> ExplainReport:
        """Structured plan/refresh report (``str()`` gives the decision
        line)."""
        return ExplainReport(
            kind="serving", backend=self.backend,
            serve_backend=self.serve_backend,
            plan_reason=getattr(self, "_base_reason", self.plan.reason),
            trail=tuple(self._refresh_notes),
            shared_artifacts=tuple(self._pool_keys()),
            extras=(("buckets", self.buckets),
                    ("generation", self.generation)))

    def close(self) -> None:
        """Release this runtime's shared-artifact references (idempotent)."""
        if self._pool is not None and self._pool_refs:
            self._pool.release(self._pool_keys())
        self._pool_refs = {}

    # -- incremental maintenance --------------------------------------------
    def refresh(self) -> str:
        """Apply pending catalog deltas to the serving state, in place.

        Same-shape appends, updates and deletions take the delta path:
        per-arm ``PKIndex.extend`` sorted merges, ``prefuse_rows`` over
        just the changed dimension rows and predicate-mask scatters, with
        **no new compile** (``num_compiles`` unchanged).  Capacity growth
        or compaction rebuilds the state under a new generation, so
        ``num_compiles`` restarts from 0.  Either way the latency windows
        reset; compile records follow the generation (the delta path keeps
        the live record, a rebuild archives it).  Returns the decision line
        (also appended to ``plan.reason``).  Not fenced against concurrent
        :meth:`serve` calls.
        """
        if self.catalog is None:
            return self._note("refresh=no-op(detached: no catalog)")
        cat = self.catalog
        try:
            changed = {t: cat.deltas_since(t, self.versions.get(t, 0))
                       for t in _serving_tables(self.query)}
        except CatalogHistoryError:
            return self._rebuild("history-compacted: runtime staler than "
                                 "the delta log")
        changed = {n: d for n, d in changed.items() if d}
        if not changed:
            return self._note("refresh=no-op(versions unchanged)")
        why = rebuild_reason(changed)
        if why is not None:
            return self._rebuild(why)
        chained = {t for a in self.query.arms if a.links
                   for t in chain_tables(a)}
        if chained & set(changed):
            # A delta anywhere along a chain changes the collapsed virtual
            # dimension (composed pointers, gathered features, folded
            # validity): re-collapse and rebind through the rebuild path.
            # The flat-arm delta path below stays for other appends.
            touched = ",".join(sorted(chained & set(changed)))
            return self._rebuild(
                f"chain tables changed: {touched} re-collapsed")
        line = self._refresh_delta(changed)
        self._reset_stats()
        return line

    def _note(self, line: str) -> str:
        if not self._refresh_notes:
            self._base_reason = self.plan.reason
        self._refresh_notes.append(line)
        self.plan = dataclasses.replace(
            self.plan, reason="; ".join([self._base_reason,
                                         *self._refresh_notes]))
        return line

    def _reset_stats(self):
        """Latency percentiles restart at a refresh boundary.  Compile
        records are kept: they are per generation, and a rebuild has
        already archived the live one in ``_install``."""
        self._lat.clear()
        self._lat_chunked.clear()

    def _rebuild(self, why: str) -> str:
        q = self.query
        dims, chains, chain_keys = _serving_dims(self.catalog, q,
                                                 pool=self._pool)
        # The plan restarts from its base reason (accumulated refresh notes
        # would otherwise grow the new base without bound); a mesh plan's
        # placement is planned again from the current table shapes.
        reason = (self._base_reason if self._refresh_notes
                  else self.plan.reason)
        if self.sharded is not None:
            reason = reason[:reason.rindex("; place=[")]
        base_plan = dataclasses.replace(self.plan, reason=reason)
        # Re-acquire from the pool first (fresh references keep the shared
        # refcounts above zero), then release the replaced state's ones.
        old_keys = self._pool_keys()
        arms, h, sharded, self.plan, self._pool_refs = _serving_artifacts(
            q, dims, self._model, self.backend, base_plan, mesh=self._mesh,
            shard_axis=self._shard_axis,
            shard_threshold_bytes=self._shard_threshold_bytes,
            pool=self._pool, chains=chains, chain_keys=chain_keys)
        if self._pool is not None and old_keys:
            self._pool.release(old_keys)
        self._refresh_notes.clear()
        self._install(arms, h, sharded)
        self._reset_stats()
        self.versions = {t: self.catalog.version(t)
                         for t in _serving_tables(q)}
        return self._note(f"refresh=rebuild({why}; replanned, jit cache "
                          "reset)")

    def _refresh_delta_pooled(self, changed) -> str:
        """Pool-backed delta refresh: each ``pool.get`` delta-updates the
        shared entry at most once per catalog change however many runtimes
        and plans reference it; rebinding the refreshed tensors is all that
        remains per runtime."""
        pool = self._pool
        pkeys = self._pool_refs.get("partials", ())
        parts = tuple(pool.get(k) for k in pkeys) if pkeys else None
        new_arms = []
        for j, (old, ref) in enumerate(zip(self._arms,
                                           self._pool_refs["arms"])):
            # (ikey, mkey, tkey[, ckey]): a chained arm's mask and feature
            # rows live on its pooled chain entry.
            ikey, mkey, tkey, ckey = (tuple(ref) + (None,) * 4)[:4]
            if ckey is not None:
                cc = pool.get(ckey)
                dmask = cc.dmask
                tbl = parts[j] if parts is not None else cc.table.matrix
            else:
                dmask = pool.get(mkey)
                tbl = parts[j] if parts is not None else pool.get(tkey)
            new_arms.append(dataclasses.replace(
                old, index=pool.get(ikey), dmask=dmask,
                table=tbl.contiguous()))
        self._arms = tuple(new_arms)
        self.versions = {t: self.catalog.version(t)
                         for t in _serving_tables(self.query)}
        touched = ",".join(f"{n}+{len(changed[n])}" for n in sorted(changed))
        return self._note(f"refresh=delta({touched}; pooled artifacts, "
                          "0 new compiles)")

    def _refresh_delta(self, changed) -> str:
        if self._pool is not None and self._pool_refs.get("arms"):
            return self._refresh_delta_pooled(changed)
        q = self.query
        cat = self.catalog
        # Chain tables never reach this path (refresh() rebuilds on any
        # chain delta), but chained arms still shape the prefuse feature
        # slices: resolve them so arm j's slice offsets match the build.
        dims, _, _ = _serving_dims(cat, q)
        new_arms = list(self._arms)
        new_sharded = (list(self.sharded.arms) if self.sharded is not None
                       else None)
        for j, arm in enumerate(q.arms):
            if arm.table not in changed:
                continue
            dim = cat[arm.table]
            dev = dim.device
            span, dirty, _, deleted = changed_spans(changed[arm.table])
            ids = [torch.as_tensor(dirty, dtype=torch.int64, device=dev)]
            if span is not None:
                ids.append(torch.arange(span[0], span[1], device=dev))
            ids = torch.unique(torch.cat(ids))
            # Tombstoned rows need only the validity scatter: their partial
            # rows, keys and slots are untouched (deletion is a pure
            # validity fold), so they join the mask ids but not the
            # recompute.
            touched = torch.unique(torch.cat([ids, torch.as_tensor(
                deleted, dtype=torch.int64, device=dev)]))
            if not touched.numel():   # e.g. only no-op deltas in history
                continue
            old = self._arms[j]
            table = (old.table if new_sharded is None
                     else new_sharded[j].table)
            if ids.numel():
                # Partial (fused) or projected-feature (nonfused) rows: only
                # the changed dimension rows are recomputed and scattered
                # into a copy — the cold build's rows, bit for bit.  A
                # placed table copies only the blocks owning them.
                if self.backend == "fused":
                    rows = prefuse_rows(dims, self._model, j, ids)
                else:
                    rows = dim.matrix[ids] @ mapping_matrix(
                        dim.columns, arm.feature_cols, device=dev)
                if new_sharded is not None:
                    table = table.scatter_rows(ids, rows)
                else:
                    table = table.clone()
                    table[ids] = rows
            dmask = old.dmask.clone()
            dmask[touched] = _mask_rows(dim, arm.preds, touched)
            if new_sharded is not None:
                new_sharded[j] = extend_sharded_arm(
                    self.sharded, j, table, dim.key(arm.pk_col), dmask,
                    int(touched.min()), int(touched.max()) + 1)
                new_arms[j] = dataclasses.replace(old, dmask=dmask)
                continue
            index = old.index
            if span is not None:
                index = index.extend(dim.key(arm.pk_col)[span[0]:span[1]],
                                     torch.arange(span[0], span[1],
                                                  device=dev))
            new_arms[j] = dataclasses.replace(old, index=index, dmask=dmask,
                                              table=table)
        self._arms = tuple(new_arms)
        if new_sharded is not None:
            self.sharded = dataclasses.replace(self.sharded,
                                               arms=tuple(new_sharded))
        self.versions = {t: cat.version(t) for t in _serving_tables(q)}
        touched = ",".join(f"{n}+{len(changed[n])}" for n in sorted(changed))
        return self._note(f"refresh=delta({touched}; shapes kept, "
                          "0 new compiles)")

    # -- the online program --------------------------------------------------
    def _forward(self, fks: torch.Tensor) -> torch.Tensor:
        """Predictions for one padded ``(J, bucket)`` int32 key block."""
        if self._forward_impl is not None:      # the sharded program
            return self._forward_impl(fks, serving_arm_state(self.sharded))
        joins = []
        for arm, fk in zip(self._arms, fks):
            fj = arm.index.probe(fk)
            joins.append(FactoredJoin(fj.ptr, fj.found & arm.dmask[fj.ptr]))
        valid = joins[0].found
        for fj in joins[1:]:
            valid = valid & fj.found
        tables = [a.table for a in self._arms]
        if self.backend == "fused":
            out = self._online_fused(joins, valid, tables)
        else:
            out = self._online_nonfused(joins, valid, tables)
        return out * valid[:, None].to(out.dtype)

    def _online_fused(self, joins, valid, tables) -> torch.Tensor:
        if self.serve_backend == "kernel":
            from ...kernels.fused_star_gather import fused_star_gather
            return fused_star_gather(
                torch.stack([fj.ptr for fj in joins]),
                torch.stack([fj.found for fj in joins]), tables, self._h)
        acc = None
        for fj, tbl in zip(joins, tables):
            part = fj.apply(tbl)
            acc = part if acc is None else acc + part
        if self._h is None:
            return acc
        # Invalid rows are zeroed before the compare here and after it on
        # the kernel path; the final multiply by ``valid`` in ``_forward``
        # makes both 0 there.
        acc = acc * valid[:, None].to(acc.dtype)
        return (acc == self._h[None, :].to(acc.dtype)).to(acc.dtype)

    def _online_nonfused(self, joins, valid, tables) -> torch.Tensor:
        t = torch.cat([fj.apply(tbl) for fj, tbl in zip(joins, tables)],
                      dim=1) * valid[:, None].to(torch.float32)
        if (self.serve_backend == "kernel"
                and isinstance(self._model, DecisionTreeGEMM)):
            from ...kernels.tree_predict import tree_predict
            m = self._model
            return tree_predict(t.contiguous(), m.F, m.v, m.H, m.h)
        return self._model.apply(t)

    # -- request entry points ------------------------------------------------
    def serve(self, requests) -> torch.Tensor:
        """Predictions for a request batch of any size.

        ``requests`` is a mapping ``{fk_col: (n,) ints}`` covering
        :attr:`request_keys`, a sequence of per-arm key arrays in arm order,
        or a stacked ``(num_arms, n)`` array (numpy or torch, on any
        device).  Returns ``(n, l)`` float32 predictions on the tables'
        device; a request whose key misses a live, predicate-passing
        dimension row scores zero (inner-join semantics).
        """
        t0 = time.perf_counter()
        fks = self._normalize(requests)
        n = fks.shape[1]
        if n == 0:
            return torch.zeros((0, self.out_width), dtype=torch.float32,
                               device=self._device)
        top = self.buckets[-1]
        if n > top:
            # Oversized batch: top-bucket chunks, timed as one request.
            out = torch.cat([self._serve_bucketed(fks[:, i:i + top],
                                                  record=False)
                             for i in range(0, n, top)])
            if self._sync_stats:
                self._sync()
            self._lat_chunked.append(time.perf_counter() - t0)
            return out
        return self._serve_bucketed(fks, t0=t0)

    def _serve_bucketed(self, fks: np.ndarray, *, record: bool = True,
                        t0: Optional[float] = None) -> torch.Tensor:
        t0 = time.perf_counter() if t0 is None else t0
        bucket, padded = self._admit(fks)
        return self._execute(padded, bucket, t0,
                             record=record)[:fks.shape[1]]

    def _admit(self, fks: np.ndarray) -> Tuple[int, torch.Tensor]:
        """Pad normalized ``(J, n)`` request keys into the smallest bucket
        that holds them, as one block on the tables' device (callers chunk
        batches larger than ``buckets[-1]`` first)."""
        n = fks.shape[1]
        if n > self.buckets[-1]:
            raise ValueError(
                f"cannot admit {n} rows in one step: top bucket is "
                f"{self.buckets[-1]} (chunk the batch first)")
        bucket = next(b for b in self.buckets if b >= n)
        padded = np.full((fks.shape[0], bucket), PAD_KEY, np.int32)
        padded[:, :n] = fks
        return bucket, torch.from_numpy(padded).to(self._device)

    def _execute(self, padded: torch.Tensor, bucket: int, t0: float, *,
                 record: bool = True) -> torch.Tensor:
        """Run one bucket-shaped block; returns the full padded output.

        The sample runs from ``t0``, which the caller takes before the key
        checks, so it covers them, the padding and the copy to the device
        as well as the online program.  A bucket's first call lands in
        ``compile_ms``, not in the percentile window; ``record=False`` keeps
        a chunk of an oversized request out of the window too (the caller
        times the request).
        """
        first = bucket not in self._compile_s
        out = self._forward(padded)
        if self._sync_stats:
            self._sync()
        dt = time.perf_counter() - t0
        if first:
            self._compile_s[bucket] = dt
        elif record:
            self._lat.setdefault(
                bucket, collections.deque(maxlen=LATENCY_WINDOW)).append(dt)
        return out

    def _sync(self) -> None:
        devices = (self._mesh.distinct_devices()
                   if self._mesh is not None else (self._device,))
        for dev in devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _normalize(self, requests) -> np.ndarray:
        """The request's key columns as one ``(J, n)`` int32 host array."""
        keys = self.request_keys
        if isinstance(requests, Mapping):
            missing = [k for k in keys if k not in requests]
            if missing:
                raise KeyError(f"request batch missing fk columns {missing}")
            cols = [requests[k] for k in keys]
        elif (isinstance(requests, (np.ndarray, torch.Tensor))
              and requests.ndim == 1):
            cols = [requests]
        else:
            cols = list(requests)
        if len(cols) != len(keys):
            raise ValueError(
                f"expected {len(keys)} fk columns {keys}, got {len(cols)}")
        out = [_host_keys(c) for c in cols]
        n = out[0].shape[0]
        if any(c.shape[0] != n for c in out):
            raise ValueError("ragged fk columns in one request batch")
        for key, c in zip(keys, out):
            if np.any(c == PAD_KEY):
                raise SentinelKeyError(
                    f"request column {key!r} contains the padding sentinel "
                    f"{PAD_KEY} (PAD_KEY): sentinel-valued keys are "
                    "indistinguishable from padded slots and would "
                    "silently score zero")
        return np.stack(out)


def requests_from_rows(fact: Table, q: PredictiveQuery, row_ids
                       ) -> Dict[str, np.ndarray]:
    """Lift fact-row ids into the equivalent FK request batch.

    The request carries exactly the fact rows' foreign keys, so serving it
    reproduces ``CompiledQuery.predict_rows`` for rows that pass the
    fact-side predicates.  Negative ids wrap, as numpy indexing does; ids
    outside ``[-capacity, capacity)`` raise ``IndexError``.
    """
    ids = torch.as_tensor(row_ids).to(torch.int64).reshape(-1)
    cap = fact.capacity
    if bool(((ids < -cap) | (ids >= cap)).any()):
        raise IndexError(f"row ids outside [-{cap}, {cap}) of fact table "
                         f"{fact.name!r}")
    ids = ids.to(fact.device)
    return {a.fk_col: fact.key(a.fk_col)[ids].cpu().numpy()
            for a in q.arms}


def _serving_dims(catalog: Mapping[str, Table], q: PredictiveQuery,
                  pool=None
                  ) -> Tuple[List[DimSpec],
                             Tuple[Optional[CollapsedChain], ...],
                             Tuple[Optional[tuple], ...]]:
    """Each arm as a ``DimSpec`` of its served features, snowflake chains
    collapsed offline.

    Flat arms resolve against the catalog; chained arms collapse (through
    the pool when there is one: the entry compiled plans use) to their
    head-granularity virtual dimension, whose columns are the arm's served
    features.  Returns ``(dims, chains, chain_keys)``, with ``None`` chain
    slots for flat arms.
    """
    dims, chains, chain_keys = [], [], []
    for a in q.arms:
        if a.links:
            if pool is not None:
                cc, ckey = pool.acquire_chain(a)
            else:
                cc, ckey = resolve_chain(catalog, a), None
            dims.append(DimSpec(cc.table, a.fk_col, a.pk_col,
                                tuple(cc.table.columns)))
            chains.append(cc)
            chain_keys.append(ckey)
        else:
            dims.append(DimSpec(catalog[a.table], a.fk_col, a.pk_col,
                                a.feature_cols))
            chains.append(None)
            chain_keys.append(None)
    return dims, tuple(chains), tuple(chain_keys)


def _serving_artifacts(q: PredictiveQuery, dims: Sequence[DimSpec], model,
                       backend: str, plan: QueryPlan, *, mesh=None,
                       shard_axis: str = "model",
                       shard_threshold_bytes: Optional[int] = None,
                       pool=None,
                       chains: Sequence[Optional[CollapsedChain]] = (),
                       chain_keys: Sequence[Optional[tuple]] = ()):
    """The state serving reads: per-arm PK indices, predicate masks and
    prefused partials (fused) or projected feature rows (nonfused), plus
    the tree's compare vector, and (mesh) the placed shards.  Shared by the
    cold build and the runtime's rebuild, so both place and index the state
    alike (the placement planned from the current table shapes).  Returns
    ``(arms, h, sharded, plan, pool_refs)``, ``pool_refs`` ``{}`` when
    unpooled.

    On the mesh path the arms keep no whole index or table: the placed
    per-shard slices replace them.

    With a ``pool`` the tables, masks and indices are the pool's shared
    entries — the ones compiled plans over the same arms hold, so a
    runtime and a fused plan over one arm reference one partial.

    ``chains``/``chain_keys`` come from :func:`_serving_dims`: a chained
    arm's mask is the collapsed chain's validity (head liveness, hop misses
    and every predicate along the chain folded in), its nonfused feature
    rows are the virtual matrix, and its PK index is the real head table's
    (the virtual PK column is the head's, so the entry is shared with
    compiled plans over the head).
    """
    chains = tuple(chains) + (None,) * (len(dims) - len(chains))
    chain_keys = (tuple(chain_keys)
                  + (None,) * (len(dims) - len(chain_keys)))
    partial_keys: Tuple = ()
    feat_keys = [None] * len(dims)
    if backend == "fused":
        if pool is not None:
            tables, h, partial_keys = pool.acquire_partials(
                dims, model, chains=chains)
        else:
            pre = prefuse_dims(dims, model)
            tables, h = pre.partials, pre.h
    else:
        tables = []
        for j, (d, cc) in enumerate(zip(dims, chains)):
            if cc is not None:
                # The virtual matrix is the projected feature table (its
                # columns are the arm's served features); it lives in the
                # pool under the chain key, not a features entry.
                tables.append(cc.table.matrix)
            elif pool is not None:
                tbl, feat_keys[j] = pool.acquire_features(d.dim.name,
                                                          d.feature_cols)
                tables.append(tbl)
            else:
                tables.append(d.dim.matrix @ mapping_matrix(
                    d.dim.columns, d.feature_cols, device=d.dim.device))
        h = None
    arms, arm_refs = [], []
    for arm, d, tbl, tkey, cc, ckey in zip(q.arms, dims, tables, feat_keys,
                                           chains, chain_keys):
        if pool is not None:
            if cc is not None:
                dmask, mkey = cc.dmask, None
            else:
                dmask, mkey = pool.acquire_dmask(arm.table, arm.preds)
            index, ikey = pool.acquire_pkindex(arm.table, arm.pk_col)
            arm_refs.append((ikey, mkey, tkey, ckey))
        else:
            if cc is not None:
                dmask = cc.dmask
            else:
                dmask = d.dim.valid_mask()
                for p in arm.preds:
                    dmask = dmask & p.mask(d.dim)
            index = (None if mesh is not None
                     else pk_index(d.dim.key(arm.pk_col)))
        arms.append(_ArmIndex(
            fk_col=arm.fk_col, index=index, dmask=dmask,
            table=None if mesh is not None else tbl.contiguous()))
    refs = ({"arms": tuple(arm_refs), "partials": tuple(partial_keys)}
            if pool is not None else {})
    sharded = None
    if mesh is not None:
        tables = [t.contiguous() for t in tables]
        specs, plan = place_tables(mesh, tables, plan, axis=shard_axis,
                                   threshold_bytes=shard_threshold_bytes)
        sharded = shard_prefused_partials(
            mesh, [(arm.fk_col, d.dim.key(arm.pk_col), a.dmask, tbl)
                   for arm, d, a, tbl in zip(q.arms, dims, arms, tables)],
            h, specs, shard_axis=shard_axis)
    return tuple(arms), h, sharded, plan, refs


def compile_serving(catalog: Mapping[str, Table], q: PredictiveQuery, *,
                    backend: str = "auto", serve_backend: str = "auto",
                    buckets: Sequence[int] = DEFAULT_BUCKETS,
                    sync_stats: bool = True,
                    memory_budget_bytes: Optional[int] = None,
                    mesh=None, shard_axis: str = "model",
                    shard_threshold_bytes: Optional[int] = None,
                    pool=None) -> ServingRuntime:
    """Compile ``q``'s online phase over (batch, fk...) request batches.

    ``catalog`` is a :class:`~repro_torch.core.laq.catalog.Catalog`, whose
    mutations the runtime absorbs through :meth:`ServingRuntime.refresh`,
    or a plain mapping of table names to the port's ``Table``s, wrapped
    read-only.  The runtime runs on the tables' device (every arm's table
    must be on one device) and the model head moves there.  The offline
    phase (PK sort, predicate masks, Eq. 1 prefusion) runs here, once.

    ``backend`` picks fused/nonfused ("auto": the cost model, sized at the
    top bucket); ``serve_backend`` picks the kernels or plain torch
    ("auto": the kernel on ``cuda`` where the shapes fit).  ``sync_stats``
    synchronizes the device before each latency sample's clock stops;
    without it the samples time the enqueue only.
    ``memory_budget_bytes`` bounds the resident prefused partials: past
    it "auto" serves nonfused (``plan_fusion``'s budget rule).

    Requests are FK tuples, not fact rows, so ``q.fact_preds`` cannot apply
    and are ignored; dimension predicates fold into the lookup validity.

    ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh`) switches on
    sharded serving: per-arm placement by ``plan_partition_spec``
    (replicate below ``shard_threshold_bytes``, row-shard over
    ``shard_axis`` with the ``safe_spec`` fallback above it), buckets
    rounded up to multiples of the mesh's data-parallel size, and each
    batch served by shard-local probes and gathers (see
    :mod:`~repro_torch.core.query.sharding`).  A mesh runs the plain
    gathers: ``"auto"`` resolves to ``"torch"`` and ``"kernel"`` raises.

    ``pool`` is a ``Session``'s
    :class:`~repro_torch.core.query.multiquery.ArtifactPool`; it engages
    only against its own catalog and without a mesh.
    """
    if q.model is None:
        raise ValueError("compile_serving requires a model head")
    if q.model_preds:
        raise ValueError(
            "compile_serving does not take prediction filters "
            "(model_preds): serving returns raw predictions per request "
            "row — filter in the aggregate path (compile_query) instead")
    if not q.arms:
        raise ValueError("compile_serving requires at least one star arm")
    for name, arg, allowed in (
            ("backend", backend, ("auto", "fused", "nonfused")),
            ("serve_backend", serve_backend, SERVE_BACKENDS)):
        if arg not in allowed:
            raise ValueError(f"{name} {arg!r} not one of {allowed}")
    serve_backend = resolve_mesh_serve_backend(serve_backend, mesh)
    if not isinstance(catalog, Catalog):
        warnings.warn(
            "passing a plain mapping to compile_serving is deprecated and "
            "will require an explicit wrap in a future release; construct "
            "a repro_torch.core.laq.Catalog (or go through Session) — see "
            "the migration table in repro_torch.core.query",
            DeprecationWarning, stacklevel=2)
    catalog = Catalog.wrap(catalog)
    for arm in q.arms:   # teach the catalog the join contract (PK columns)
        catalog.note_unique(arm.table, arm.pk_col)
        for lk in arm.links:
            catalog.note_unique(lk.table, lk.pk_col)
    if pool is not None and (mesh is not None
                             or pool.catalog is not catalog):
        pool = None
    buckets = tuple(sorted({int(b) for b in buckets}))
    if not buckets or buckets[0] < 1:
        raise ValueError(f"buckets must be positive ints, got {buckets!r}")
    if mesh is not None:
        dp = dp_size(mesh)
        buckets = tuple(sorted({-(-b // dp) * dp for b in buckets}))

    dev = catalog[q.arms[0].table].device
    for a in q.arms:
        for t in chain_tables(a):
            if catalog[t].device != dev:
                raise ValueError(
                    f"table {t!r} is on {catalog[t].device}, table "
                    f"{q.arms[0].table!r} on {dev}: a runtime serves from "
                    "one device")
    dims, chains, chain_keys = _serving_dims(catalog, q, pool=pool)
    q = dataclasses.replace(q, model=q.model.to(dev))
    plan = plan_query(q.model, buckets[-1], [int(d.dim.nvalid) for d in dims],
                      platform=dev.type, selectivity=1.0, num_groups=0,
                      out_width=q.model.l,
                      memory_budget_bytes=memory_budget_bytes)
    backend = plan.backend if backend == "auto" else backend
    serve_backend = effective_serve_backend(plan, serve_backend, backend,
                                            q.model, len(dims),
                                            platform=dev.type)
    if serve_backend != plan.serve_backend:
        plan = dataclasses.replace(
            plan, serve_backend=serve_backend,
            reason=f"{plan.reason}; serve={serve_backend} (caller override)")
    arms, h, sharded, plan, pool_refs = _serving_artifacts(
        q, dims, q.model, backend, plan, mesh=mesh, shard_axis=shard_axis,
        shard_threshold_bytes=shard_threshold_bytes, pool=pool,
        chains=chains, chain_keys=chain_keys)
    return ServingRuntime(query=q, plan=plan, backend=backend,
                          serve_backend=serve_backend, buckets=buckets,
                          arms=arms, model=q.model, h=h,
                          sync_stats=sync_stats, catalog=catalog, pool=pool,
                          pool_refs=pool_refs, sharded=sharded, mesh=mesh,
                          shard_axis=shard_axis,
                          shard_threshold_bytes=shard_threshold_bytes)
