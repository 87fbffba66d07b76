"""Out-of-core execution for the fact axis: chunked streaming aggregation
(port of ``repro.core.query.streaming``).

MatFast-style block partitioning (PAPERS.md, arxiv 2110.01767): the fact
table is split along the row axis into fixed-size chunks, and the fused
online program the in-core ``run()`` executes is applied chunk by chunk.
Dimension-side artifacts (prefused partials, the tree's compare vector)
stay on the device once and every chunk shares them unchanged; only the
fact-axis leaves (matrix rows, validity, join pointers and liveness, group
ids) stream.

Host and device buffers
-----------------------
:meth:`StreamExecutor.rebind` copies the fact-axis leaves of a plan's
state into host buffers laid out chunk by chunk, the last chunk padded
(padded rows are invalid, point at row 0 with no liveness and carry the
overflow group id, so they only ever touch the dropped ``num_groups``
slot).  On a CUDA plan the host buffers are **pinned**, allocated once per
executor, and a later ``rebind`` overwrites them in place while the
capacity holds (a capacity change raises: the owning plan recompiles).
The join pointers and liveness are laid out ``(chunk, J, chunk_rows)``, so
one chunk is one contiguous ``(J, chunk_rows)`` block: one
``fused_star_gather`` launch per chunk, through ``predict_fused_kernel``.

``run`` copies chunk *i+1* into one of two device chunk buffers on a side
stream while the fold of chunk *i* runs on the current stream; an event
per buffer orders each copy before its fold and each fold before the next
copy into its buffer.  Peak device residency is the shared dimension side,
two chunks and the accumulator.  On the CPU the same code runs with plain
host tensors and no streams.

The port has no traces.  ``traces`` keeps the reference's attribute and
counts how many times the device chunk buffers were (re)built: once, at
the first ``run``.  A same-capacity ``rebind`` leaves it unchanged — the
port's counterpart of the reference's "zero retraces".

Exactness contract
------------------
The executor carries one accumulator of ``num_groups + 1`` slots across
chunks and continues the fold the in-core program performs, with the same
operations: ``index_add_`` for sum, count and mean, ``scatter_reduce_``
with ``amin``/``amax`` for min and max, then the in-core final forms
(isfinite-zero for min/max, sum/count for mean).

* On the CPU, ``index_add_`` folds rows in row order, so a chunked fold
  is bit for bit one whole-table ``index_add_``: grouped aggregates and
  ungrouped count/min/max equal the in-core ``run()`` bit for bit, for
  every chunk size (1, non-divisors of the row count, sizes past it).
  Ungrouped sum/mean reduce the whole fact axis with no segment structure
  to carry the order through; they agree up to float summation order.
* On the card, ``index_add_`` adds with atomics (as the in-core group-by
  does, ``core/laq/aggregation.py``).  Counts, min and max are exact, and
  so are sums of integer-valued data (the workload fuzzer's); float sums
  are held to rtol 1e-5.

The fused online program is chunk-stable by construction (per-row gathers
into dimension-side partials plus elementwise adds, no cross-row matmul),
which is why streaming pins ``backend="fused"``, ``join_backend="gather"``
and ``agg_backend="segment"`` (``compile_query`` rejects conflicting
explicit overrides).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from ..fusion.pipeline import (PrefusedStar, predict_fused,
                               predict_fused_kernel)
from ..laq.join import FactoredJoin
from ..laq.star import StarJoin
from .ir import PREDICTION, eval_value

#: Default rows per chunk when streaming is requested without a size.
DEFAULT_CHUNK_ROWS = 65536


def plan_chunk_rows(requested, capacity: int, row_bytes: int,
                    budget_bytes: Optional[int]) -> Optional[int]:
    """Resolve a ``stream_chunk_rows`` request to a concrete chunk size.

    ``requested`` may be a positive int (use it), ``"auto"`` (size chunks to
    the budget, default chunk when none), or ``None`` (stream only when a
    budget is given and the fact working set exceeds it).  Returns ``None``
    for the in-core path.
    """
    if requested is None or requested == 0:
        if budget_bytes is None:
            return None
        if capacity * max(row_bytes, 1) <= budget_bytes:
            return None
        requested = "auto"
    if requested == "auto":
        if budget_bytes is None:
            return min(DEFAULT_CHUNK_ROWS, max(capacity, 1))
        rows = budget_bytes // max(row_bytes, 1)
        return int(min(max(rows, 1), max(capacity, 1)))
    rows = int(requested)
    if rows < 1:
        raise ValueError(f"stream_chunk_rows must be >= 1, got {rows}")
    return rows


def assert_pool_dimension_side(pool, refs: Dict, state: Dict,
                               star: StarJoin) -> None:
    """Assert pooled artifacts compose with streaming as designed.

    Pooled dimension-side artifacts (prefused partials) must be the very
    tensors every chunk shares: identical (by object) to the plan state's
    and sized by the dimension capacity, never the fact's.  Pooled
    fact-axis join columns are the tensors the executor copies chunk by
    chunk: shared with the state by object too, and never written by
    streaming.  A violation means a copy slipped in between the pool and
    the chunk program.
    """
    parts = state.get("partials") or ()
    part_ids = {id(p) for p in parts}
    for k in refs.get("partials", ()):
        if id(pool.get(k)) not in part_ids:
            raise AssertionError(
                f"pooled partial {k} is not the array the streamed plan "
                "shares across chunks — dimension-side artifacts must flow "
                "from the pool to every chunk unchanged")
    for p, d in zip(parts, star.dims):
        if int(p.shape[0]) != d.dim.capacity:
            raise AssertionError(
                f"prefused partial for {d.dim.name!r} is "
                f"{int(p.shape[0])}-row, expected the dimension capacity "
                f"{d.dim.capacity}: partials must stay dimension-side "
                "(fact-sized partials would have to stream)")
    ptr_ids = {id(p) for p in state["ptrs"]}
    found_ids = {id(f) for f in state["founds"]}
    for (_ikey, jkey, _mkey) in refs.get("arms", ()):
        ptr, found = pool.get(jkey)
        if id(ptr) not in ptr_ids or id(found) not in found_ids:
            raise AssertionError(
                f"pooled join {jkey} diverged from the streamed plan's "
                "pointers — chunking must slice the shared arrays, not "
                "copies")


class StreamExecutor:
    """Chunked executor of one compiled query's online aggregate program.

    Built by ``compile_query`` when a plan streams.  Holds the fact-axis
    state leaves in host buffers (pinned on a CUDA plan), the shared
    dimension-side leaves, and two device chunk buffers.  ``run()`` gives
    the aggregate dict the in-core program gives (see the module docstring
    for the exactness contract); ``rebind(state)`` swaps refreshed state
    into the same buffers while the capacity is unchanged.

    ``out_widths`` maps each non-count aggregate to the width of its values
    (``None`` for one value per row), ``use_kernel`` says whether the
    chunk's predictions run on ``fused_star_gather``.
    """

    def __init__(self, *, star: StarJoin, state: Dict, aggregates,
                 model, num_groups: int, fact_desc: str, chunk_rows: int,
                 out_widths: Dict[str, Optional[int]],
                 use_kernel: bool = False):
        self._star0 = star
        self._fact0 = star.fact
        self._aggregates = tuple(aggregates)
        self._model = model
        self._num_groups = int(num_groups)
        self._fact_desc = fact_desc
        self._grouped = state["gid"] is not None
        self._use_kernel = bool(use_kernel)
        self._capacity = int(state["fact_matrix"].shape[0])
        self._device = state["valid"].device
        self.chunk_rows = int(min(max(chunk_rows, 1), max(self._capacity, 1)))
        self.n_chunks = max(1, math.ceil(self._capacity / self.chunk_rows))
        self._widths = dict(out_widths)
        self._needs_count = any(a.op in ("count", "mean")
                                for a in self._aggregates)
        self.traces = 0
        self._host: Dict[str, torch.Tensor] = {}
        self._bufs = None       # two device chunk buffers, built at run()
        self._side = None       # the copy stream (CUDA plans)
        self._copied = None     # per buffer: event after its copy
        self._folded = None     # per buffer: event after its fold
        self._alloc_host(state)
        self.rebind(state)

    # -- host buffers --------------------------------------------------------
    def _alloc_host(self, state: Dict) -> None:
        """The chunk-major host buffers, padded to whole chunks (pinned on
        a CUDA plan).  Padding is written here once; ``rebind`` writes
        only the live ``capacity`` rows."""
        pin = self._device.type == "cuda"
        n, cr = self.n_chunks, self.chunk_rows
        rows = n * cr
        cap = self._capacity
        ncols = int(state["fact_matrix"].shape[1])
        n_arms = len(state["ptrs"])

        def empty(shape, dtype):
            return torch.empty(shape, dtype=dtype, pin_memory=pin)

        h = {"fact_matrix": empty((rows, ncols), torch.float32),
             "valid": empty((rows,), torch.bool),
             "ptrs": empty((n, n_arms, cr), torch.int32),
             "founds": empty((n, n_arms, cr), torch.bool)}
        h["fact_matrix"][cap:] = 0.0
        h["valid"][cap:] = False
        # The last chunk's padded rows point at row 0 with no liveness.
        tail = cap - (n - 1) * cr
        h["ptrs"][n - 1, :, tail:] = 0
        h["founds"][n - 1, :, tail:] = False
        if self._grouped:
            h["gid"] = empty((rows,), torch.int32)
            h["gid"][cap:] = self._num_groups
        self._host = h

    def _copy_arms(self, dst: torch.Tensor, cols) -> None:
        """Per-arm ``(capacity,)`` columns into the ``(chunk, J, rows)``
        host layout."""
        cr = self.chunk_rows
        full, rem = divmod(self._capacity, cr)
        for j, col in enumerate(cols):
            if full:
                dst[:full, j].copy_(col[:full * cr].reshape(full, cr))
            if rem:
                dst[full, j, :rem].copy_(col[full * cr:])

    # -- state binding -------------------------------------------------------
    def rebind(self, state: Dict) -> None:
        """Swap in refreshed state: the fact-axis leaves are copied into
        the same host buffers; the chunk buffers are kept.  A capacity
        change raises (the owning plan recompiles instead)."""
        if int(state["fact_matrix"].shape[0]) != self._capacity:
            raise ValueError(
                "stream rebind with a different fact capacity "
                f"({int(state['fact_matrix'].shape[0])} vs "
                f"{self._capacity}): capacity growth recompiles")
        if (state["gid"] is not None) != self._grouped:
            raise ValueError("stream rebind changed group-by structure")
        if self._side is not None:
            # The last run's copies may still read the host buffers.
            self._side.synchronize()
        cap = self._capacity
        h = self._host
        h["fact_matrix"][:cap].copy_(state["fact_matrix"])
        h["valid"][:cap].copy_(state["valid"])
        self._copy_arms(h["ptrs"], state["ptrs"])
        self._copy_arms(h["founds"], state["founds"])
        if self._grouped:
            h["gid"][:cap].copy_(state["gid"])
        self._shared = {"partials": state["partials"], "h": state["h"]}

    # -- device chunk buffers ------------------------------------------------
    def _build_buffers(self) -> None:
        """Two device chunk buffers (and on a CUDA plan the copy stream and
        the events that order copies and folds)."""
        dev, cr = self._device, self.chunk_rows
        h = self._host
        self._bufs = []
        for _ in range(2):
            buf = {"fact_matrix": torch.empty(
                       (cr, h["fact_matrix"].shape[1]), dtype=torch.float32,
                       device=dev),
                   "valid": torch.empty((cr,), dtype=torch.bool, device=dev),
                   "ptrs": torch.empty(tuple(h["ptrs"].shape[1:]),
                                       dtype=torch.int32, device=dev),
                   "founds": torch.empty(tuple(h["founds"].shape[1:]),
                                         dtype=torch.bool, device=dev),
                   "gid": (torch.empty((cr,), dtype=torch.int32, device=dev)
                           if self._grouped else None)}
            self._bufs.append(buf)
        if dev.type == "cuda":
            self._side = torch.cuda.Stream(device=dev)
            self._copied = [torch.cuda.Event() for _ in range(2)]
            self._folded = [torch.cuda.Event() for _ in range(2)]
        self.traces += 1

    def _copy_chunk(self, i: int) -> None:
        """Host chunk ``i`` into device buffer ``i % 2`` (on the side
        stream of a CUDA plan, after the buffer's previous fold)."""
        b = i % 2
        buf, h = self._bufs[b], self._host
        lo, hi = i * self.chunk_rows, (i + 1) * self.chunk_rows

        def copy():
            buf["fact_matrix"].copy_(h["fact_matrix"][lo:hi],
                                     non_blocking=True)
            buf["valid"].copy_(h["valid"][lo:hi], non_blocking=True)
            buf["ptrs"].copy_(h["ptrs"][i], non_blocking=True)
            buf["founds"].copy_(h["founds"][i], non_blocking=True)
            if self._grouped:
                buf["gid"].copy_(h["gid"][lo:hi], non_blocking=True)

        if self._side is None:
            copy()
            return
        with torch.cuda.stream(self._side):
            # After the buffer's last fold, this run's or the previous
            # one's (waiting on a never-recorded event is a no-op).
            self._side.wait_event(self._folded[b])
            copy()
            self._copied[b].record(self._side)

    # -- the chunk fold ------------------------------------------------------
    def _acc_shape(self, width):
        lead = (self._num_groups + 1,) if self._grouped else ()
        return lead + ((width,) if width is not None else ())

    def _init_acc(self) -> Dict[str, torch.Tensor]:
        dev = self._device
        acc = {}
        if self._needs_count:
            acc["count"] = torch.zeros(self._acc_shape(None),
                                       dtype=torch.float32, device=dev)
        for agg in self._aggregates:
            if agg.op == "count":
                continue
            shape = self._acc_shape(self._widths[agg.name])
            fill = {"min": float("inf"), "max": float("-inf")}.get(agg.op,
                                                                    0.0)
            acc[agg.name] = torch.full(shape, fill, dtype=torch.float32,
                                       device=dev)
        return acc

    def _chunk_predictions(self, chunk: Dict) -> torch.Tensor:
        """The fused online phase on the chunk: per-row gathers into the
        shared partials, the same bits whatever the chunking."""
        pre = PrefusedStar(tuple(self._shared["partials"]), self._shared["h"])
        star_v = dataclasses.replace(self._star0, row_valid=chunk["valid"])
        if self._use_kernel:
            return predict_fused_kernel(star_v, pre, ptrs=chunk["ptrs"],
                                        founds=chunk["founds"])
        joins = tuple(FactoredJoin(p, f)
                      for p, f in zip(chunk["ptrs"], chunk["founds"]))
        return predict_fused(dataclasses.replace(star_v, joins=joins), pre)

    def _chunk_values(self, agg, pred, chunk):
        """The compiler's per-aggregate values on a chunk view."""
        if agg.value == PREDICTION:
            return pred                          # already validity-masked
        fact_v = dataclasses.replace(self._fact0,
                                     matrix=chunk["fact_matrix"])
        vals = eval_value(fact_v, agg.value,
                          query=f"{agg.name!r} on {self._fact_desc!r}")
        if agg.op in ("min", "max"):
            return vals       # invalid rows are masked by gid / ±inf below
        return torch.where(chunk["valid"], vals, 0.0)

    def _fold(self, acc: Dict, chunk: Dict) -> None:
        """Fold one chunk into the carried accumulator, in place."""
        valid = chunk["valid"]
        gid = chunk["gid"].to(torch.int64) if self._grouped else None
        pred = (self._chunk_predictions(chunk)
                if self._model is not None else None)
        if self._needs_count:
            ones = valid.to(torch.float32)
            if self._grouped:
                acc["count"].index_add_(0, gid, ones)
            else:
                acc["count"] += ones.sum()
        for agg in self._aggregates:
            if agg.op == "count":
                continue
            vals = self._chunk_values(agg, pred, chunk)
            a = acc[agg.name]
            if self._grouped:
                # The carried (num_groups+1)-slot accumulator continues the
                # in-core segment fold.
                if agg.op in ("min", "max"):
                    idx = gid
                    if vals.dim() > 1:
                        idx = gid[:, None].expand_as(vals)
                    a.scatter_reduce_(0, idx, vals,
                                      reduce="amin" if agg.op == "min"
                                      else "amax", include_self=True)
                else:
                    a.index_add_(0, gid, vals)
            elif agg.op in ("min", "max"):
                fill = float("inf") if agg.op == "min" else float("-inf")
                mask = valid[:, None] if vals.dim() > 1 else valid
                masked = torch.where(mask, vals, fill)
                if agg.op == "min":
                    torch.minimum(a, masked.amin(0), out=a)
                else:
                    torch.maximum(a, masked.amax(0), out=a)
            else:
                a += vals.sum(0)

    def _finalize_fn(self, acc: Dict) -> Dict[str, torch.Tensor]:
        """Drop the overflow slot and apply the in-core final forms
        (isfinite-zero for min/max, sum/count for mean)."""
        g = self._num_groups
        count = acc.get("count")
        if count is not None and self._grouped:
            count = count[:g]
        out = {}
        for agg in self._aggregates:
            if agg.op == "count":
                out[agg.name] = count
                continue
            a = acc[agg.name]
            if self._grouped:
                a = a[:g]
            if agg.op in ("min", "max"):
                out[agg.name] = torch.where(torch.isfinite(a), a, 0.0)
            elif agg.op == "mean":
                c = count.clamp(min=1.0)
                out[agg.name] = a / (c[:, None] if a.dim() > 1 else c)
            else:
                out[agg.name] = a
        return out

    # -- the chunk loop ------------------------------------------------------
    def run(self) -> Dict[str, torch.Tensor]:
        """Stream every chunk through the fold and finalize.

        Double-buffered: chunk *i+1*'s copy is issued before chunk *i*'s
        fold, so on a CUDA plan the copy overlaps the fold.
        """
        if self._bufs is None:
            self._build_buffers()
        acc = self._init_acc()
        cuda = self._side is not None
        main = torch.cuda.current_stream(self._device) if cuda else None
        self._copy_chunk(0)
        for i in range(self.n_chunks):
            if i + 1 < self.n_chunks:
                self._copy_chunk(i + 1)
            b = i % 2
            if cuda:
                main.wait_event(self._copied[b])
            self._fold(acc, self._bufs[b])
            if cuda:
                self._folded[b].record(main)
        return self._finalize_fn(acc)

    # -- introspection -------------------------------------------------------
    def chunk_bytes(self) -> int:
        """Approximate device bytes one chunk occupies."""
        per_row = (self._host["fact_matrix"].shape[1] * 4 + 1
                   + self._host["ptrs"].shape[1] * 5)
        if self._grouped:
            per_row += 4
        return int(self.chunk_rows * per_row)

    def describe(self) -> str:
        return (f"stream: {self.n_chunks} chunk(s) x {self.chunk_rows} rows "
                f"(~{self.chunk_bytes() / 1e6:.1f} MB/chunk)")
