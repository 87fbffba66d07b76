"""Async admission scheduler: open-loop traffic on top of ``ServingRuntime``
(port of ``repro.core.query.scheduler``, one device).

``ServingRuntime.serve`` is a closed loop — one caller, one bucketed batch
at a time, nothing owning admission.  Prediction queries in production
arrive the other way round: many concurrent clients, a mix of point
lookups and analytical scans, and a latency target per class.  This module
adds the admission layer:

Coalescing under an SLO
    Arriving FK requests queue per plan and are coalesced into one
    bucket-shaped batch per *admission step*.  A step fires when the queue
    holds a top bucket's worth of rows, when the oldest queued request has
    waited ``slo_ms`` (the flush deadline), or at once for work already
    mid-flight.

Chunked admission
    Admission is capped at the top bucket per step, and a large request is
    served as a cursor over consecutive steps, sharing each step with
    whatever interactive rows are pending.

Priority lanes with starvation freedom
    Two lanes per plan, ``"interactive"`` (default) and ``"batch"``.
    Interactive rows are admitted first each step; the batch lane keeps a
    row reservation (``batch_reserve_rows``) whenever it has work, so
    neither lane can starve the other.

Bounded queues with backpressure
    Each lane's queue is bounded in rows (``max_queued_rows``); a
    submission past the bound raises :class:`SchedulerBackpressureError`
    in the submitting caller.

Many plans, one drain loop
    Any number of runtimes register with one scheduler; a single drain
    thread forms and executes steps round-robin across plans.

Refresh fencing (drain-then-swap)
    :meth:`AdmissionScheduler.refresh` pauses new admissions, lets started
    requests finish their remaining chunks, waits until the device has
    finished that work, then swaps each runtime's state.  Every request
    sees exactly one catalog version.

The device
    The drain thread runs each runtime's steps on that runtime's device and
    on the CUDA stream that was current there when the runtime registered
    (its default stream unless the registering caller chose another), so
    results come back on the stream the caller works on.  It is a daemon
    thread, joined by :meth:`AdmissionScheduler.close`.

Bit-exactness: the bucket programs are row-independent, so coalescing,
chunking and lane interleaving never change a request's values —
scheduled results equal ``ServingRuntime.serve`` of the same request bit
for bit.

Entry points: ``Session.scheduler()`` / ``QueryBuilder.serve(async_=True)``
(which returns a :class:`ScheduledPlan`), or an :class:`AdmissionScheduler`
built directly.  ``submit`` returns a ``concurrent.futures.Future``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from .explain import ExplainReport
from .serving import ServingRuntime

#: Default flush deadline: a queued request is admitted at most this many
#: milliseconds after submission even when the bucket has not filled.
DEFAULT_SLO_MS = 2.0

#: Default per-lane queue bound, in rows (not requests).
DEFAULT_MAX_QUEUED_ROWS = 16384

#: Priority lanes, admission order per step (after mid-flight work).
LANES = ("interactive", "batch")

#: Per-lane completed-request latency samples kept for percentiles.
STATS_WINDOW = 4096


class SchedulerBackpressureError(RuntimeError):
    """Submission rejected: the plan's lane queue is at its row bound."""


class SchedulerClosedError(RuntimeError):
    """The scheduler was closed; no further submissions are accepted."""


@dataclasses.dataclass
class _Pending:
    """One submitted request, from queue to resolved future.

    ``served`` is the admission cursor: a request larger than one step is
    admitted chunk by chunk across steps, its output segments gathered in
    ``parts``.
    """

    fks: np.ndarray          # (J, n) int32 request keys
    n: int
    lane: str
    future: Future
    t_submit: float
    served: int = 0
    parts: List[torch.Tensor] = dataclasses.field(default_factory=list)


class _PlanQueue:
    """Per-plan admission state: two bounded lanes + mid-flight work."""

    def __init__(self, name: str, runtime: ServingRuntime,
                 max_queued_rows: int, batch_reserve: int,
                 stream: Optional[torch.cuda.Stream]):
        self.name = name
        self.runtime = runtime
        self.stream = stream     # the CUDA stream steps run on (None: CPU)
        self.max_queued_rows = max_queued_rows
        self.batch_reserve = batch_reserve
        self.lanes: Dict[str, Deque[_Pending]] = {
            lane: collections.deque() for lane in LANES}
        self.inflight: Dict[str, Deque[_Pending]] = {
            lane: collections.deque() for lane in LANES}
        # Unadmitted rows per lane (backpressure accounting).
        self.queued_rows: Dict[str, int] = {lane: 0 for lane in LANES}
        self.lat: Dict[str, Deque[float]] = {
            lane: collections.deque(maxlen=STATS_WINDOW) for lane in LANES}
        self.steps = 0
        self.admitted_rows = 0
        self.padded_rows = 0
        self.rejected = 0

    def has_inflight(self) -> bool:
        return any(self.inflight[lane] for lane in LANES)

    def has_work(self) -> bool:
        return self.has_inflight() or any(self.lanes[la] for la in LANES)

    def on_device(self):
        """The context steps of this plan run in: its device and stream."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def flush_state(self, now: float, *, fenced: bool, slo_s: float,
                    closed: bool) -> Tuple[bool, Optional[float]]:
        """``(ready, seconds_until_deadline)`` for the drain loop's poll.

        Mid-flight work is always ready; queued work is ready when it fills
        the top bucket, when the oldest request hits the SLO deadline, or
        when the scheduler is closing.  During a fence only mid-flight work
        is admissible.
        """
        if self.has_inflight():
            return True, None
        if fenced:
            return False, None
        rows = sum(self.queued_rows.values())
        if rows == 0:
            return False, None
        if closed or rows >= self.runtime.buckets[-1]:
            return True, None
        oldest = min(q[0].t_submit for q in self.lanes.values() if q)
        if now >= oldest + slo_s:
            return True, None
        return False, oldest + slo_s - now


@dataclasses.dataclass(frozen=True)
class ScheduledPlan:
    """A registered plan's handle: submit requests, read its stats."""

    scheduler: "AdmissionScheduler"
    name: str
    runtime: ServingRuntime

    def submit(self, requests, *, lane: str = "interactive") -> Future:
        """Enqueue one request batch; see :meth:`AdmissionScheduler.submit`."""
        return self.scheduler.submit(self.name, requests, lane=lane)

    def stats(self) -> Dict:
        """This plan's admission/latency stats (see scheduler ``stats``)."""
        return self.scheduler.stats()[self.name]


class AdmissionScheduler:
    """Request queues + one drain loop over any number of serving plans.

    ``slo_ms`` is the coalescing flush deadline (0 serves immediately);
    ``max_queued_rows`` bounds each lane's queue in rows;
    ``batch_reserve_rows`` is the batch lane's guaranteed per-step share
    while it has work (default: a quarter of the plan's top bucket).
    ``auto_start=False`` skips the drain thread — tests and steppers then
    drive admission deterministically through :meth:`step`.

    Thread contract: ``submit`` is safe from any thread; execution happens
    on the single drain thread, so the runtimes are never entered
    concurrently.  Do not call ``runtime.serve``/``refresh`` directly while
    a scheduler owns the runtime — route refreshes through
    :meth:`refresh`, which fences in-flight work first.
    """

    def __init__(self, *, slo_ms: float = DEFAULT_SLO_MS,
                 max_queued_rows: int = DEFAULT_MAX_QUEUED_ROWS,
                 batch_reserve_rows: Optional[int] = None,
                 auto_start: bool = True):
        if slo_ms < 0:
            raise ValueError(f"slo_ms must be >= 0, got {slo_ms}")
        if max_queued_rows < 1:
            raise ValueError(
                f"max_queued_rows must be >= 1, got {max_queued_rows}")
        self.slo_ms = float(slo_ms)
        self._slo_s = float(slo_ms) / 1e3
        self._max_queued_rows = int(max_queued_rows)
        self._batch_reserve_rows = batch_reserve_rows
        self._plans: Dict[str, _PlanQueue] = {}
        self._cv = threading.Condition()
        self._closed = False
        self._fences = 0
        self._refresh_trail: Deque[str] = collections.deque(maxlen=32)
        self._drained = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if auto_start:
            self._thread = threading.Thread(
                target=self._drain_loop, name="admission-drain", daemon=True)
            self._thread.start()

    # -- lifecycle -----------------------------------------------------------
    def __enter__(self) -> "AdmissionScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close(cancel=exc[0] is not None)

    def close(self, *, cancel: bool = False) -> None:
        """Stop the scheduler; drains queued work first unless ``cancel``.

        With ``cancel=True`` every unresolved future fails with
        :class:`SchedulerClosedError` instead (mid-flight requests
        included — their partial output is dropped).  The drain thread is
        joined before this returns.
        """
        with self._cv:
            if self._closed:
                return
            self._closed = True
            if cancel:
                for plan in self._plans.values():
                    for store in (plan.inflight, plan.lanes):
                        for lane in LANES:
                            while store[lane]:
                                p = store[lane].popleft()
                                plan.queued_rows[lane] -= p.n - p.served
                                self._fail(p, SchedulerClosedError(
                                    "scheduler closed before the request "
                                    "was served"))
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join()
        else:
            while self._step() > 0:   # manual mode: drain inline
                pass

    @property
    def closed(self) -> bool:
        return self._closed

    # -- registration --------------------------------------------------------
    def register(self, runtime: ServingRuntime, name: Optional[str] = None,
                 *, max_queued_rows: Optional[int] = None,
                 batch_reserve_rows: Optional[int] = None) -> ScheduledPlan:
        """Add a compiled plan to the drain loop; idempotent per runtime.

        Returns the plan's :class:`ScheduledPlan` handle.  ``name``
        defaults to ``plan<N>``; per-plan ``max_queued_rows`` /
        ``batch_reserve_rows`` override the scheduler defaults.  Steps of a
        runtime on a CUDA device run on the stream current there now.
        """
        with self._cv:
            if self._closed:
                raise SchedulerClosedError("cannot register on a closed "
                                           "scheduler")
            for existing in self._plans.values():
                if existing.runtime is runtime:
                    return ScheduledPlan(self, existing.name, runtime)
            if name is None:
                name = f"plan{len(self._plans)}"
            if name in self._plans:
                raise ValueError(f"plan name {name!r} already registered "
                                 f"(names: {sorted(self._plans)})")
            reserve = batch_reserve_rows
            if reserve is None:
                reserve = self._batch_reserve_rows
            if reserve is None:
                reserve = max(1, runtime.buckets[-1] // 4)
            dev = runtime._device
            stream = (torch.cuda.current_stream(dev)
                      if dev.type == "cuda" else None)
            self._plans[name] = _PlanQueue(
                name, runtime,
                max_queued_rows or self._max_queued_rows,
                min(int(reserve), runtime.buckets[-1]), stream)
            self._cv.notify_all()
        return ScheduledPlan(self, name, runtime)

    def is_registered(self, runtime: ServingRuntime) -> bool:
        with self._cv:
            return any(p.runtime is runtime for p in self._plans.values())

    @property
    def plan_names(self) -> Tuple[str, ...]:
        with self._cv:
            return tuple(self._plans)

    # -- submission ----------------------------------------------------------
    def submit(self, plan: str, requests, *,
               lane: str = "interactive") -> Future:
        """Enqueue one request batch; returns a Future of the predictions.

        ``requests`` takes every form ``ServingRuntime.serve`` accepts and
        is validated here, in the caller (missing, ragged or
        sentinel-valued keys raise at once).  ``lane`` is
        ``"interactive"`` (point lookups, admitted first) or ``"batch"``
        (analytical scans, chunked through the reserved share).  Raises
        :class:`SchedulerBackpressureError` when the lane's row bound is
        hit and :class:`SchedulerClosedError` after :meth:`close`.
        """
        if lane not in LANES:
            raise ValueError(f"unknown lane {lane!r}; lanes are {LANES}")
        with self._cv:
            if plan not in self._plans:
                raise KeyError(f"unknown plan {plan!r}; registered: "
                               f"{sorted(self._plans)}")
            pq = self._plans[plan]
        fks = pq.runtime._normalize(requests)
        n = int(fks.shape[1])
        future: Future = Future()
        if n == 0:
            future.set_result(torch.zeros((0, pq.runtime.out_width),
                                          dtype=torch.float32,
                                          device=pq.runtime._device))
            return future
        with self._cv:
            if self._closed:
                raise SchedulerClosedError(
                    "scheduler is closed; no further submissions")
            queued = pq.queued_rows[lane]
            if queued + n > pq.max_queued_rows:
                pq.rejected += 1
                raise SchedulerBackpressureError(
                    f"plan {plan!r} lane {lane!r} is at capacity: {queued} "
                    f"rows queued + {n} submitted > bound "
                    f"{pq.max_queued_rows}; shed load or retry later")
            pq.lanes[lane].append(_Pending(
                fks=fks, n=n, lane=lane, future=future,
                t_submit=time.perf_counter()))
            pq.queued_rows[lane] += n
            self._cv.notify_all()
        return future

    # -- refresh fencing -----------------------------------------------------
    def refresh(self, runtime: Optional[ServingRuntime] = None
                ) -> Dict[str, str]:
        """Drain-then-swap: fence in-flight work, then refresh runtimes.

        New admissions pause; requests already started run to completion so
        no request spans two data generations; the device finishes every
        step's work; then each registered runtime's ``refresh()`` applies
        pending catalog deltas (``runtime`` narrows the swap to one plan —
        the fence is still global).  Queued but unstarted requests are
        served entirely after the swap.  Returns the per-plan decision
        lines.
        """
        with self._cv:
            self._fences += 1
            self._drained.clear()
            self._cv.notify_all()
        try:
            if self._thread is None:
                while any(p.has_inflight() for p in self._plans.values()):
                    self._step()
            else:
                self._drained.wait()
            with self._cv:
                plans = list(self._plans.values())
            for p in plans:
                if p.stream is not None:
                    p.stream.synchronize()   # no step's work left in flight
            targets = [p for p in plans
                       if runtime is None or p.runtime is runtime]
            out = {}
            for p in targets:
                with p.on_device():
                    out[p.name] = p.runtime.refresh()
            with self._cv:
                for name, line in out.items():
                    self._refresh_trail.append(f"{name}: {line}")
            return out
        finally:
            with self._cv:
                self._fences -= 1
                self._cv.notify_all()

    def explain(self) -> ExplainReport:
        """Structured scheduler report: ``trail`` holds the most recent
        fenced-refresh lines (``"<plan>: <runtime refresh line>"``),
        ``extras`` the fleet's counters."""
        with self._cv:
            extras = (
                ("plans", tuple(sorted(self._plans))),
                ("steps", sum(p.steps for p in self._plans.values())),
                ("admitted_rows",
                 sum(p.admitted_rows for p in self._plans.values())),
                ("rejected",
                 sum(p.rejected for p in self._plans.values())),
                ("closed", self._closed),
            )
            return ExplainReport(kind="scheduler",
                                 trail=tuple(self._refresh_trail),
                                 extras=extras)

    # -- stats ---------------------------------------------------------------
    def stats(self) -> Dict[str, Dict]:
        """Per-plan admission/latency report: ``steps``, ``admitted_rows`` /
        ``padded_rows`` (bucket-shape overhead), ``rejected``
        (backpressure), current ``queued_rows``, and per-lane
        completed-request latency percentiles in ms, submit to result per
        request — what an open-loop client sees."""
        with self._cv:
            out: Dict[str, Dict] = {}
            for name, plan in self._plans.items():
                lanes = {}
                for lane in LANES:
                    ts = plan.lat[lane]
                    entry: Dict[str, float] = {"count": len(ts)}
                    if ts:
                        ms = np.asarray(ts) * 1e3
                        entry.update(
                            p50=float(np.percentile(ms, 50)),
                            p95=float(np.percentile(ms, 95)),
                            p99=float(np.percentile(ms, 99)))
                    lanes[lane] = entry
                out[name] = {
                    "steps": plan.steps,
                    "admitted_rows": plan.admitted_rows,
                    "padded_rows": plan.padded_rows,
                    "rejected": plan.rejected,
                    "queued_rows": dict(plan.queued_rows),
                    "lanes": lanes,
                }
            return out

    # -- the drain loop ------------------------------------------------------
    def _drain_loop(self) -> None:
        while True:
            with self._cv:
                while True:
                    now = time.perf_counter()
                    ready, wait = self._poll_locked(now)
                    if ready:
                        break
                    if self._closed:
                        return
                    if self._fences and not any(
                            p.has_inflight() for p in self._plans.values()):
                        self._drained.set()
                    self._cv.wait(timeout=wait)
                steps = []
                for plan in ready:
                    take, total = self._form_step_locked(plan)
                    if total:
                        steps.append((plan, take, total))
            for plan, take, total in steps:
                self._exec_step(plan, take, total)

    def _poll_locked(self, now: float
                     ) -> Tuple[List[_PlanQueue], Optional[float]]:
        ready: List[_PlanQueue] = []
        wait: Optional[float] = None
        for plan in self._plans.values():
            r, w = plan.flush_state(now, fenced=self._fences > 0,
                                    slo_s=self._slo_s, closed=self._closed)
            if r:
                ready.append(plan)
            elif w is not None:
                wait = w if wait is None else min(wait, w)
        return ready, wait

    def _form_step_locked(self, plan: _PlanQueue
                          ) -> Tuple[List[Tuple[_Pending, int, int]], int]:
        """One admission step: which rows of which requests run next.

        Capacity is the top bucket.  Order: mid-flight interactive, queued
        interactive (up to capacity minus the batch reservation while the
        batch lane has work), then mid-flight batch and queued batch into
        everything left.  Under a fence only mid-flight work is admitted.
        Mutates cursors and queues; execution happens outside the lock.
        """
        cap = plan.runtime.buckets[-1]
        left = cap
        take: List[Tuple[_Pending, int, int]] = []

        def drain(src: Deque[_Pending], budget: int,
                  to_inflight: bool) -> int:
            taken = 0
            while src and budget > 0:
                p = src[0]
                if p.future.cancelled():
                    src.popleft()
                    plan.queued_rows[p.lane] -= p.n - p.served
                    continue
                c = min(p.n - p.served, budget)
                take.append((p, p.served, c))
                p.served += c
                plan.queued_rows[p.lane] -= c
                taken += c
                budget -= c
                if p.served == p.n:
                    src.popleft()
                elif to_inflight:
                    src.popleft()
                    plan.inflight[p.lane].append(p)
            return taken

        if self._fences:
            for lane in LANES:
                left -= drain(plan.inflight[lane], left, False)
        else:
            batch_work = (plan.inflight["batch"] or plan.lanes["batch"])
            reserve = min(plan.batch_reserve, left) if batch_work else 0
            budget = left - reserve
            taken = drain(plan.inflight["interactive"], budget, False)
            taken += drain(plan.lanes["interactive"], budget - taken, True)
            left -= taken
            left -= drain(plan.inflight["batch"], left, False)
            left -= drain(plan.lanes["batch"], left, True)
        return take, cap - left

    def _exec_step(self, plan: _PlanQueue,
                   take: List[Tuple[_Pending, int, int]], total: int) -> None:
        runtime = plan.runtime
        try:
            t0 = time.perf_counter()
            if len(take) == 1:
                p0, s0, c0 = take[0]
                cols = p0.fks[:, s0:s0 + c0]
            else:
                cols = np.concatenate([p.fks[:, s:s + c]
                                       for p, s, c in take], axis=1)
            with plan.on_device():
                bucket, padded = runtime._admit(cols)
                body = runtime._execute(padded, bucket, t0)[:total]
                done = time.perf_counter()
                offset = 0
                for p, s, c in take:
                    seg = body[offset:offset + c]
                    offset += c
                    if s == 0 and c == p.n:
                        self._resolve(plan, p, seg, done)
                    else:
                        # A chunked request: its segments concatenate on
                        # the device, as ``serve`` joins an oversized
                        # batch's chunks.
                        p.parts.append(seg)
                        if p.served == p.n:
                            self._resolve(plan, p, torch.cat(p.parts), done)
            plan.steps += 1
            plan.admitted_rows += total
            plan.padded_rows += bucket - total
        except Exception as exc:   # noqa: BLE001 — futures carry the error
            for p, _, _ in take:
                self._fail(p, exc)

    def _resolve(self, plan: _PlanQueue, p: _Pending, result,
                 done: float) -> None:
        try:
            p.future.set_result(result)
        except InvalidStateError:
            return    # cancelled between admission and completion
        plan.lat[p.lane].append(done - p.t_submit)

    @staticmethod
    def _fail(p: _Pending, exc: BaseException) -> None:
        try:
            p.future.set_exception(exc)
        except InvalidStateError:
            pass

    # -- manual stepping (deterministic tests / external drivers) ------------
    def _step(self) -> int:
        """Form + execute one admission step per plan with work, now.

        Ignores the SLO wait (anything queued is admitted at once, subject
        to fence and lane rules) — the deterministic drive used when
        ``auto_start=False``.  Returns the rows admitted by this call.
        """
        with self._cv:
            steps = []
            for plan in self._plans.values():
                if not (plan.has_inflight()
                        or (not self._fences and plan.has_work())):
                    continue
                take, total = self._form_step_locked(plan)
                if total:
                    steps.append((plan, take, total))
        served = 0
        for plan, take, total in steps:
            self._exec_step(plan, take, total)
            served += total
        return served

    def step(self) -> int:
        """Public manual drive (only without the drain thread)."""
        if self._thread is not None:
            raise RuntimeError(
                "step() is for auto_start=False schedulers; the drain "
                "thread owns admission here")
        return self._step()
