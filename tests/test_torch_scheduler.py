"""Port parity: the admission scheduler (``repro_torch.core.query.scheduler``)
against ``tests/test_scheduler.py``, case by case.

The contract, as the reference's:
  * scheduled results equal synchronous ``serve`` of the same requests bit
    for bit — coalesced small batches, chunked oversized batches, several
    plans on one drain loop, and across a fenced ``refresh()``;
  * the SLO flush serves a lone request without a full bucket (drain
    thread, wall clock; the bound is the reference's ``waited < 10.0``);
  * the lanes are starvation-free both ways; bounded queues reject with
    ``SchedulerBackpressureError``; closed schedulers with
    ``SchedulerClosedError``;
  * normalization errors raise in the submitting caller.

Every case runs on the same seeded 2-arm star in both packages: the port's
synchronous ``serve`` is held to the reference's (exact for tree heads,
1 ulp — rtol 1e-6 — for linear heads, whose rows sum in another framework),
and the port's scheduled results to the port's ``serve`` exactly.
Deterministic cases drive ``auto_start=False`` schedulers through
``step()``; every scheduler is closed by a context manager and every
``Future.result`` has a timeout.  The reference's sharded case is in
``tests/test_torch_sharding_b.py``.
"""
import concurrent.futures
import time

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core.query as RQ
from repro.core.fusion import LinearOperator as RefLinear
from repro.core.laq import Catalog as RefCatalog
from repro.core.laq import Table as RefTable
from repro.core.laq.selection import Pred as RefPred
from repro_torch.core.laq import PAD_KEY
from repro_torch.core.query import (AdmissionScheduler, ScheduledPlan,
                                    SchedulerBackpressureError,
                                    SchedulerClosedError, SentinelKeyError,
                                    Session, compile_serving)
from torch_parity import Both, assert_preds_equal, port_query, to_np

BUCKETS = (4, 16)   # top bucket 16 → default batch reserve 4
WAIT = 30           # seconds any Future.result may wait


# --------------------------------------------------------------------- data
def star_catalog(seed: int = 3, n_d1: int = 40, n_d2: int = 12,
                 slack: int = 16) -> Both:
    """The reference's ``star_catalog`` and its port copy, in step."""
    rng = np.random.default_rng(seed)
    d1 = {"pk": np.arange(n_d1) * 2,          # even keys; odd keys = appends
          "a": rng.normal(size=n_d1), "b": rng.normal(size=n_d1)}
    d2 = {"pk2": np.arange(n_d2), "c": rng.normal(size=n_d2)}
    f = {"fk1": rng.integers(0, 2 * n_d1, 8),
         "fk2": rng.integers(0, n_d2, 8), "val": rng.normal(size=8)}
    return Both(RefCatalog({
        "d1": RefTable.from_columns("d1", d1, key_cols=("pk",),
                                    capacity=n_d1 + slack),
        "d2": RefTable.from_columns("d2", d2, key_cols=("pk2",),
                                    capacity=n_d2 + slack),
        "fact": RefTable.from_columns("fact", f, key_cols=("fk1", "fk2")),
    }))


def _ref_query(seed: int = 0) -> RQ.PredictiveQuery:
    rng = np.random.default_rng(seed)
    model = RefLinear(jnp.asarray(
        rng.normal(size=(3, 2)).astype(np.float32)))
    return RQ.PredictiveQuery(
        fact="fact",
        arms=(RQ.ArmSpec("d1", "fk1", "pk", ("a", "b"),
                         (RefPred("a", ">", -1.0),)),
              RQ.ArmSpec("d2", "fk2", "pk2", ("c",))),
        model=model,
        aggregates=(RQ.Aggregate(RQ.PREDICTION, "sum", "pred"),))


def _requests(rng, n, n_d1=40, n_d2=12):
    """Random per-arm FK batch; ~1/8 of keys miss."""
    return {"fk1": rng.integers(0, int(2 * n_d1 * 9 / 8), n).astype(np.int32),
            "fk2": rng.integers(0, int(n_d2 * 9 / 8), n).astype(np.int32)}


def _runtimes(both, seed=0):
    """(port runtime, reference runtime) of one query on one catalog."""
    rq = _ref_query(seed)
    return (compile_serving(both.port, port_query(rq), buckets=BUCKETS),
            RQ.compile_serving(both.ref, rq, buckets=BUCKETS))


def _check(got, rt, ref_rt, reqs):
    """A scheduled result: the port's ``serve`` bit for bit, the
    reference's to 1 ulp."""
    want = rt.serve(reqs)
    np.testing.assert_array_equal(to_np(got), to_np(want))
    assert_preds_equal(want, ref_rt.serve(reqs), exact=False)


@pytest.fixture()
def pair():
    return _runtimes(star_catalog())


@pytest.fixture()
def sched():
    with AdmissionScheduler(auto_start=False) as s:
        yield s


# ----------------------------------------------------------- bit-exactness
def test_coalesced_step_bit_exact_and_counted(pair, sched):
    rt, ref_rt = pair
    plan = sched.register(rt, "p")
    rng = np.random.default_rng(0)
    reqs = [_requests(rng, n) for n in (2, 3, 4)]
    futs = [plan.submit(r) for r in reqs]
    assert sched.step() == 9          # one coalesced admission step
    for f, r in zip(futs, reqs):
        _check(f.result(0), rt, ref_rt, r)
    st = plan.stats()
    assert st["steps"] == 1 and st["admitted_rows"] == 9
    assert st["padded_rows"] == 16 - 9     # padded into the top bucket
    assert st["lanes"]["interactive"]["count"] == 3


def test_oversized_batch_chunks_bit_exact(pair, sched):
    rt, ref_rt = pair
    plan = sched.register(rt)
    rng = np.random.default_rng(1)
    reqs = _requests(rng, 3 * BUCKETS[-1] + 5)      # 53 rows → 4 chunks
    fut = plan.submit(reqs, lane="batch")
    steps = 0
    while not fut.done():
        assert sched.step() > 0
        steps += 1
    assert steps == 4
    _check(fut.result(0), rt, ref_rt, reqs)


def test_multiple_plans_one_drain_loop(sched):
    both = star_catalog()
    rt_a, ref_a = _runtimes(both, 0)
    rt_b, ref_b = _runtimes(both, 1)
    pa, pb = sched.register(rt_a, "a"), sched.register(rt_b, "b")
    assert sched.plan_names == ("a", "b")
    assert sched.register(rt_a).name == "a"    # idempotent per runtime
    rng = np.random.default_rng(2)
    ra, rb = _requests(rng, 7), _requests(rng, 11)
    fa, fb = pa.submit(ra), pb.submit(rb)
    assert sched.step() == 18          # one step per plan, same call
    _check(fa.result(0), rt_a, ref_a, ra)
    _check(fb.result(0), rt_b, ref_b, rb)


def test_zero_row_submission_resolves_immediately(pair, sched):
    rt, _ = pair
    plan = sched.register(rt)
    fut = plan.submit({"fk1": np.zeros(0, np.int32),
                       "fk2": np.zeros(0, np.int32)})
    assert tuple(fut.result(0).shape) == (0, rt.out_width)


# ------------------------------------------------------------------- lanes
def test_point_lookups_interleave_with_inflight_analytical(pair, sched):
    rt, ref_rt = pair
    plan = sched.register(rt)
    rng = np.random.default_rng(3)
    big = _requests(rng, 4 * BUCKETS[-1])           # 4-step analytical scan
    small = _requests(rng, 2)
    fb = plan.submit(big, lane="batch")
    assert sched.step() == BUCKETS[-1]              # scan starts alone
    fi = plan.submit(small)                         # point lookup arrives
    sched.step()
    assert fi.done() and not fb.done()              # rode along the scan
    while not fb.done():
        sched.step()
    _check(fi.result(0), rt, ref_rt, small)
    _check(fb.result(0), rt, ref_rt, big)


def test_batch_reserve_prevents_interactive_starvation(pair, sched):
    rt, ref_rt = pair
    plan = sched.register(rt)
    rng = np.random.default_rng(4)
    scan = _requests(rng, 2 * BUCKETS[-1])          # needs 32 admitted rows
    fb = plan.submit(scan, lane="batch")
    reserve = max(1, BUCKETS[-1] // 4)
    flood_budget = BUCKETS[-1] - reserve
    steps = 0
    while not fb.done():
        flood = plan.submit(_requests(rng, flood_budget))
        sched.step()
        steps += 1
        assert flood.done()                         # interactive first...
        assert steps <= int(np.ceil(2 * BUCKETS[-1] / reserve))
    _check(fb.result(0), rt, ref_rt, scan)          # ...the scan progressed


def test_unknown_lane_and_plan_are_named_errors(pair, sched):
    rt, _ = pair
    plan = sched.register(rt)
    with pytest.raises(ValueError, match="unknown lane"):
        plan.submit(_requests(np.random.default_rng(0), 1), lane="bulk")
    with pytest.raises(KeyError, match="unknown plan"):
        sched.submit("nope", _requests(np.random.default_rng(0), 1))
    with pytest.raises(ValueError, match="already registered"):
        sched.register(_runtimes(star_catalog(), 1)[0], plan.name)


# ---------------------------------------------------- backpressure / close
def test_backpressure_rejects_with_named_error(pair):
    rt, _ = pair
    with AdmissionScheduler(auto_start=False, max_queued_rows=8) as s:
        plan = s.register(rt)
        rng = np.random.default_rng(5)
        plan.submit(_requests(rng, 6))
        with pytest.raises(SchedulerBackpressureError, match="at capacity"):
            plan.submit(_requests(rng, 6))
        plan.submit(_requests(rng, 2))              # exactly at the bound
        assert plan.stats()["rejected"] == 1
        s.step()                                    # admission frees the lane
        plan.submit(_requests(rng, 8))


def test_close_drains_by_default_and_rejects_new_work(pair):
    rt, ref_rt = pair
    with AdmissionScheduler(auto_start=False) as s:
        plan = s.register(rt)
        reqs = _requests(np.random.default_rng(6), 3)
        fut = plan.submit(reqs)
        s.close()                                   # drains queued work
        _check(fut.result(0), rt, ref_rt, reqs)
        with pytest.raises(SchedulerClosedError):
            plan.submit(reqs)
        with pytest.raises(SchedulerClosedError):
            s.register(_runtimes(star_catalog(), 1)[0])


def test_close_cancel_fails_pending_futures(pair):
    rt, _ = pair
    with AdmissionScheduler(auto_start=False) as s:
        plan = s.register(rt)
        fut = plan.submit(_requests(np.random.default_rng(7), 3))
        s.close(cancel=True)
        with pytest.raises(SchedulerClosedError):
            fut.result(0)


def test_cancelled_future_is_dropped_at_admission(pair, sched):
    rt, ref_rt = pair
    plan = sched.register(rt)
    rng = np.random.default_rng(8)
    f1, keep = plan.submit(_requests(rng, 3)), _requests(rng, 2)
    f2 = plan.submit(keep)
    assert f1.cancel()
    assert sched.step() == 2                        # only the live request
    _check(f2.result(0), rt, ref_rt, keep)


# ------------------------------------------------- synchronous validation
def test_normalization_errors_raise_in_submitting_caller(pair, sched):
    rt, _ = pair
    plan = sched.register(rt)
    with pytest.raises(SentinelKeyError, match="padding sentinel"):
        plan.submit({"fk1": np.array([3, PAD_KEY], np.int32),
                     "fk2": np.array([1, 2], np.int32)})
    with pytest.raises(ValueError, match="ragged"):
        plan.submit({"fk1": np.array([3, 4], np.int32),
                     "fk2": np.array([1], np.int32)})
    with pytest.raises(KeyError):
        plan.submit({"fk1": np.array([3], np.int32)})
    assert sched.step() == 0                        # nothing was enqueued


def test_step_requires_manual_mode(pair):
    with AdmissionScheduler() as s:
        with pytest.raises(RuntimeError, match="auto_start=False"):
            s.step()


# ------------------------------------------------------------ SLO (timed)
def test_slo_flushes_lone_request_without_full_bucket(pair):
    rt, ref_rt = pair
    with AdmissionScheduler(slo_ms=5.0) as s:
        plan = s.register(rt)
        reqs = _requests(np.random.default_rng(9), 2)   # far below a bucket
        t0 = time.perf_counter()
        out = plan.submit(reqs).result(timeout=WAIT)
        waited = time.perf_counter() - t0
        _check(out, rt, ref_rt, reqs)
        # The reference's generous wall-clock bound: flushed by the
        # deadline, not held for 16 rows.
        assert waited < 10.0
        st = plan.stats()["lanes"]["interactive"]
        assert st["count"] == 1 and st["p50"] >= 0.0
    assert not s._thread.is_alive()                 # close() joined it


# -------------------------------------------------------- refresh fencing
def test_refresh_fence_keeps_request_on_one_generation():
    both = star_catalog()
    rq = _ref_query()
    q = port_query(rq)
    rt = compile_serving(both.port, q, buckets=BUCKETS)
    twin = compile_serving(both.port, q, buckets=BUCKETS)
    ref_twin = RQ.compile_serving(both.ref, rq, buckets=BUCKETS)
    rng = np.random.default_rng(10)
    # Keys of rows that only exist after the append (odd d1 keys): the old
    # and new generations answer them differently.
    reqs = {"fk1": np.concatenate([
                rng.integers(0, 80, 40), 81 + 2 * np.arange(8)]
            ).astype(np.int32),
            "fk2": rng.integers(0, 12, 48).astype(np.int32)}
    want_old = twin.serve(reqs)
    with AdmissionScheduler(auto_start=False) as s:
        plan = s.register(rt)
        fut = plan.submit(reqs, lane="batch")
        assert s.step() == BUCKETS[-1]              # mid-flight: 16/48 rows
        both.append("d1", {"pk": 81 + 2 * np.arange(8),
                           "a": rng.normal(size=8), "b": rng.normal(size=8)})
        decisions = s.refresh(rt)                   # drain, then swap
        assert fut.done()
        np.testing.assert_array_equal(to_np(fut.result(0)), to_np(want_old))
        assert decisions[plan.name] == ("refresh=delta(d1+1; shapes kept, "
                                        "0 new compiles)")
        assert decisions[plan.name] == ref_twin.refresh()
        twin.refresh()
        want_new = twin.serve(reqs)
        assert not np.array_equal(to_np(want_old), to_np(want_new))
        assert_preds_equal(want_new, ref_twin.serve(reqs), exact=False)
        f2 = plan.submit(reqs)
        while not f2.done():
            s.step()
        np.testing.assert_array_equal(to_np(f2.result(0)), to_np(want_new))
        assert any(line.startswith(f"{plan.name}: refresh=delta")
                   for line in s.explain().trail)


def test_session_routes_cached_runtime_refresh_through_fence():
    both = star_catalog()
    rq = _ref_query()
    q = port_query(rq)
    sess = Session(both.port)
    ref_sess = RQ.Session(both.ref)
    plan = sess.bind(q).serve(buckets=BUCKETS, async_=True)
    try:
        assert isinstance(plan, ScheduledPlan)
        assert sess.bind(q).serve(buckets=BUCKETS,
                                  async_=True).name == plan.name
        rng = np.random.default_rng(11)
        reqs = _requests(rng, 6)
        ref_rt = ref_sess.bind(rq).serve(buckets=BUCKETS)
        _check(plan.submit(reqs).result(WAIT),
               compile_serving(both.port, q, buckets=BUCKETS), ref_rt, reqs)
        both.append("d1", {"pk": 81 + 2 * np.arange(4),
                           "a": rng.normal(size=4), "b": rng.normal(size=4)})
        # The cached-runtime hit path fences through the scheduler.
        rt2 = sess.bind(q).serve(buckets=BUCKETS)
        assert rt2 is plan.runtime
        assert (rt2.explain().trail[-1]
                == "refresh=delta(d1+1; pooled artifacts, 0 new compiles)")
        ref_rt = ref_sess.bind(rq).serve(buckets=BUCKETS)
        assert ref_rt.explain().trail[-1] == rt2.explain().trail[-1]
        new_keys = {"fk1": (81 + 2 * np.arange(4)).astype(np.int32),
                    "fk2": np.arange(4).astype(np.int32)}
        got = plan.submit(new_keys).result(WAIT)
        _check(got, compile_serving(both.port, q, buckets=BUCKETS), ref_rt,
               new_keys)
        with pytest.raises(ValueError, match="already running"):
            sess.scheduler(slo_ms=1.0)
    finally:
        sess.scheduler().close()
    # A closed session scheduler is replaced lazily on next use.
    with sess.scheduler(slo_ms=1.0) as s:
        assert s.slo_ms == 1.0


# ------------------------------------------------------- concurrent load
def test_concurrent_submitters_all_bit_exact(pair):
    """Many threads submit through the drain thread; every result exact."""
    rt, ref_rt = pair
    rng = np.random.default_rng(12)
    batches = [_requests(rng, int(n)) for n in rng.integers(1, 40, 24)]
    want = [to_np(rt.serve(b)) for b in batches]
    for b, w in zip(batches[:4], want):
        assert_preds_equal(w, ref_rt.serve(b), exact=False)
    with AdmissionScheduler(slo_ms=1.0) as s:
        plan = s.register(rt)
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            futs = list(pool.map(
                lambda b: plan.submit(b, lane="batch"
                                      if b["fk1"].size > 20 else
                                      "interactive"),
                batches))
            got = [to_np(f.result(WAIT)) for f in futs]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not s._thread.is_alive()
