"""Port parity: the fault-tolerance runtime (``repro_torch.runtime``: the
port's own copy of ``repro.runtime``) against the reference's, driven by
the same ``SimulatedCluster`` scripts, and the reference's substrate tests
mirrored in the port.  Every comparison is exact (integers, mesh plans,
host lists and restart counts; EWMAs equal as Python floats).
"""
import numpy as np
import pytest
import torch

import repro.runtime as R
import repro_torch.runtime as T
from repro_torch.checkpoint import CheckpointManager
from repro_torch.runtime import (HeartbeatMonitor, HostFailure, MeshPlan,
                                 SimulatedCluster, StragglerMonitor,
                                 elastic_remesh, run_with_recovery)


@pytest.mark.parametrize("alive", [8, 15, 16, 250, 255, 256, 257, 502, 511,
                                   512, 513, 768, 1000])
@pytest.mark.parametrize("tp,pod", [(1, 256), (4, 256), (16, 256), (8, 64)])
def test_elastic_remesh_matches_reference(alive, tp, pod):
    if alive < tp:
        with pytest.raises(RuntimeError):
            elastic_remesh(alive, tp, pod)
        with pytest.raises(RuntimeError):
            R.elastic_remesh(alive, tp, pod)
        return
    got, want = elastic_remesh(alive, tp, pod), R.elastic_remesh(
        alive, tp, pod)
    assert (got.shape, got.axes, got.n_devices, got.data_parallel) == (
        want.shape, want.axes, want.n_devices, want.data_parallel)


def _cluster_script(mod):
    """One scripted run: stragglers, a failure, heartbeats, re-meshes."""
    cluster = mod.SimulatedCluster(n_hosts=8, devices_per_host=4)
    strag = mod.StragglerMonitor(range(8), threshold=1.5, patience=2)
    out = []
    cluster.make_slow(5, 3.0)
    cluster.make_slow(2, 1.4)
    for i in range(6):
        if i == 3:
            cluster.make_slow(5, 1.0)
        out.append(("flagged", strag.record_step(
            cluster.step_times(base=1.0 + 0.1 * i))))
        out.append(("ewma", dict(strag.ewma)))
    cluster.fail_host(3)
    cluster.advance(10.0)
    out.append(("failed", cluster.monitor.failed_hosts()))
    cluster.advance(25.0)
    out.append(("failed", sorted(cluster.monitor.failed_hosts())))
    out.append(("alive", cluster.monitor.alive_hosts()))
    plan = mod.elastic_remesh(cluster.alive_devices, model_parallel=4,
                              devices_per_pod=cluster.alive_devices)
    out.append(("plan", (plan.shape, plan.axes, plan.n_devices)))
    return out


def test_cluster_script_matches_reference():
    assert _cluster_script(T) == _cluster_script(R)


def test_heartbeat_matches_reference_under_one_clock():
    t = {"now": 0.0}
    got = HeartbeatMonitor([0, 1, 2, 3], timeout_s=10.0,
                           clock=lambda: t["now"])
    want = R.HeartbeatMonitor([0, 1, 2, 3], timeout_s=10.0,
                              clock=lambda: t["now"])
    for now, beats in ((4.0, (0, 1)), (9.0, (1, 2)), (15.0, (1,)),
                       (30.0, ()), (31.0, (0, 3))):
        t["now"] = now
        for h in beats:
            got.beat(h)
            want.beat(h)
        assert got.failed_hosts() == want.failed_hosts()
        assert got.alive_hosts() == want.alive_hosts()


class _Mgr:
    """A checkpoint manager stand-in: the latest committed step."""

    def __init__(self, steps):
        self.steps = list(steps)

    def latest_step(self):
        return self.steps[-1] if self.steps else None


def _recovery_run(mod, fail_at, max_restarts):
    cluster = mod.SimulatedCluster(n_hosts=8, devices_per_host=4)
    mgr = _Mgr([])
    calls = []

    def loop(plan, start):
        calls.append((plan.shape, start))
        for step in range(start, 20):
            if step % 5 == 0 and step:
                mgr.steps.append(step)
            if fail_at and step == fail_at[0]:
                fail_at.pop(0)
                raise mod.HostFailure(len(calls))
        return 20

    try:
        result = mod.run_with_recovery(loop, cluster, model_parallel=4,
                                       checkpoint_mgr=mgr,
                                       max_restarts=max_restarts)
    except mod.HostFailure as e:
        result = ("raised", e.host)
    return result, calls, sorted(cluster.failed)


@pytest.mark.parametrize("fails,max_restarts", [([], 3), ([7], 3),
                                                ([7, 12, 13], 3),
                                                ([3, 6, 11, 16], 3)])
def test_run_with_recovery_matches_reference(fails, max_restarts):
    assert _recovery_run(T, list(fails), max_restarts) == _recovery_run(
        R, list(fails), max_restarts)


def test_recovery_resumes_from_a_port_checkpoint(tmp_path):
    """The recovery loop with the port's ``CheckpointManager``: a host
    failure re-meshes smaller and resumes from the last committed step."""
    cluster = SimulatedCluster(n_hosts=4, devices_per_host=2)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    seen = []

    def loop(plan, start):
        seen.append((plan.n_devices, start))
        for step in range(start, 9):
            if (step + 1) % 3 == 0:
                mgr.save(step + 1, {"x": torch.tensor(float(step))})
            if step == 4 and len(seen) == 1:
                raise HostFailure(2)
        return 9

    final, restarts = run_with_recovery(loop, cluster, model_parallel=2,
                                        checkpoint_mgr=mgr)
    assert (final, restarts) == (9, 1)
    assert seen == [(8, 0), (6, 3)]
    assert mgr.all_steps() == [6, 9]


# ------------------------------- tests/test_substrates.py, in the port ----
def test_heartbeat_failure_detection():
    t = {"now": 0.0}
    mon = HeartbeatMonitor([0, 1, 2], timeout_s=10.0,
                           clock=lambda: t["now"])
    t["now"] = 5.0
    mon.beat(0)
    mon.beat(1)
    t["now"] = 12.0
    assert mon.failed_hosts() == [2]
    assert sorted(mon.alive_hosts()) == [0, 1]


def test_elastic_remesh_sheds_dp_keeps_tp():
    plan = elastic_remesh(512, model_parallel=16, devices_per_pod=256)
    assert plan.shape == (2, 16, 16)
    plan = elastic_remesh(502, model_parallel=16, devices_per_pod=256)
    assert plan.axes[-1] == "model" and plan.shape[-1] == 16
    assert plan.n_devices <= 502
    assert isinstance(plan, MeshPlan)
    with pytest.raises(RuntimeError):
        elastic_remesh(8, model_parallel=16)


def test_straggler_detection_and_recovery_flow():
    cluster = SimulatedCluster(n_hosts=8)
    strag = StragglerMonitor(range(8), threshold=1.5, patience=2)
    cluster.make_slow(5, 3.0)
    flagged = []
    for _ in range(4):
        flagged = strag.record_step(cluster.step_times())
    assert flagged == [5]
    cluster.fail_host(3)
    cluster.advance(40.0)
    assert 3 in cluster.monitor.failed_hosts()
    plan = elastic_remesh(cluster.alive_devices, model_parallel=4,
                          devices_per_pod=cluster.alive_devices)
    assert plan.n_devices <= cluster.alive_devices
    assert np.prod(plan.shape) == plan.n_devices
