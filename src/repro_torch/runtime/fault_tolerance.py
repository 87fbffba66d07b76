"""Fault-tolerant runtime: failure detection, elastic re-mesh, stragglers
(the port's own copy of ``repro.runtime.fault_tolerance``, which imports
no JAX; the port imports nothing of the reference).

At 1000+ nodes the *expected* state is "something is broken".  Three
mechanisms, all mesh-topology-aware and all testable on CPU through
``SimulatedCluster``:

1. **HeartbeatMonitor** — per-host heartbeats with a deadline; hosts missing
   the deadline are declared failed.  (On a real cluster the transport is
   the coordination service / GCS bucket heartbeat files; here it's a
   pluggable clock + store so tests can inject failures deterministically.)
2. **Elastic re-mesh** — given the surviving host set, pick the largest
   valid (pod, data, model) factorization ≤ survivors that preserves the
   model axis (TP size is fixed by the sharding plan; we shed data-parallel
   replicas first — they're stateless beyond the optimizer shards, which
   restore from the last checkpoint).  Returns the new mesh shape + the
   step to resume from.
3. **StragglerMonitor** — EWMA of per-host step times; hosts slower than
   ``threshold ×`` the fleet median for ``patience`` consecutive steps are
   flagged; policy = report / evict (treat as failed → re-mesh).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple


# ----------------------------------------------------------- heartbeats ----
class HeartbeatMonitor:
    def __init__(self, hosts: Sequence[int], timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout_s
        self.clock = clock
        now = clock()
        self.last_seen: Dict[int, float] = {h: now for h in hosts}

    def beat(self, host: int, at: Optional[float] = None):
        self.last_seen[host] = self.clock() if at is None else at

    def failed_hosts(self) -> List[int]:
        now = self.clock()
        return [h for h, t in self.last_seen.items()
                if now - t > self.timeout]

    def alive_hosts(self) -> List[int]:
        failed = set(self.failed_hosts())
        return [h for h in self.last_seen if h not in failed]


# ---------------------------------------------------------- re-meshing -----
@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    n_devices: int

    @property
    def data_parallel(self) -> int:
        total = 1
        for s, a in zip(self.shape, self.axes):
            if a in ("pod", "data"):
                total *= s
        return total


def elastic_remesh(alive_devices: int, model_parallel: int,
                   devices_per_pod: int = 256) -> MeshPlan:
    """Largest valid mesh ≤ alive_devices keeping the model axis intact.

    Sheds DP replicas first (model shards must stay complete — losing one
    makes the whole replica unusable).  Multi-pod ("pod" axis) survives only
    if ≥ 2 complete pods remain.
    """
    if alive_devices < model_parallel:
        raise RuntimeError(
            f"cannot keep TP={model_parallel} with {alive_devices} devices")
    dp_total = alive_devices // model_parallel
    pods = alive_devices // devices_per_pod
    dp_per_pod = devices_per_pod // model_parallel
    if pods >= 2 and dp_total >= pods * dp_per_pod:
        return MeshPlan((pods, dp_per_pod, model_parallel),
                        ("pod", "data", "model"),
                        pods * dp_per_pod * model_parallel)
    return MeshPlan((dp_total, model_parallel), ("data", "model"),
                    dp_total * model_parallel)


# ----------------------------------------------------------- stragglers ----
class StragglerMonitor:
    def __init__(self, hosts: Sequence[int], threshold: float = 1.5,
                 patience: int = 3, alpha: float = 0.3):
        self.threshold = threshold
        self.patience = patience
        self.alpha = alpha
        self.ewma: Dict[int, float] = {h: 0.0 for h in hosts}
        self.strikes: Dict[int, int] = {h: 0 for h in hosts}

    def record_step(self, times: Dict[int, float]) -> List[int]:
        """Feed per-host step times; returns hosts flagged as stragglers."""
        for h, t in times.items():
            prev = self.ewma.get(h, 0.0)
            self.ewma[h] = t if prev == 0.0 else \
                self.alpha * t + (1 - self.alpha) * prev
        vals = sorted(v for v in self.ewma.values() if v > 0)
        if not vals:
            return []
        median = vals[len(vals) // 2]
        flagged = []
        for h, v in self.ewma.items():
            if v > self.threshold * median:
                self.strikes[h] = self.strikes.get(h, 0) + 1
                if self.strikes[h] >= self.patience:
                    flagged.append(h)
            else:
                self.strikes[h] = 0
        return flagged


# ------------------------------------------------------ simulated fleet ----
class SimulatedCluster:
    """Deterministic cluster simulation for CPU tests of the FT loop."""

    def __init__(self, n_hosts: int, devices_per_host: int = 4):
        self.n_hosts = n_hosts
        self.devices_per_host = devices_per_host
        self.t = 0.0
        self.failed: set = set()
        self.slow: Dict[int, float] = {}
        self.monitor = HeartbeatMonitor(range(n_hosts), timeout_s=30.0,
                                        clock=lambda: self.t)

    def advance(self, dt: float):
        self.t += dt
        for h in range(self.n_hosts):
            if h not in self.failed:
                self.monitor.beat(h, at=self.t)

    def fail_host(self, host: int):
        self.failed.add(host)

    def make_slow(self, host: int, factor: float):
        self.slow[host] = factor

    def step_times(self, base: float = 1.0) -> Dict[int, float]:
        return {h: base * self.slow.get(h, 1.0)
                for h in range(self.n_hosts) if h not in self.failed}

    @property
    def alive_devices(self) -> int:
        return (self.n_hosts - len(self.failed)) * self.devices_per_host


# ------------------------------------------------------ recovery driver ----
def run_with_recovery(train_loop: Callable, cluster: SimulatedCluster,
                      model_parallel: int, checkpoint_mgr,
                      max_restarts: int = 3):
    """Orchestration skeleton: run → on failure, re-mesh → restore → resume.

    ``train_loop(mesh_plan, start_step)`` runs until it raises
    ``HostFailure`` (simulated) or returns the final step.
    """
    restarts = 0
    plan = elastic_remesh(cluster.alive_devices, model_parallel,
                          devices_per_pod=cluster.alive_devices)
    step = checkpoint_mgr.latest_step() or 0
    while True:
        try:
            return train_loop(plan, step), restarts
        except HostFailure as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            cluster.fail_host(e.host)
            plan = elastic_remesh(cluster.alive_devices, model_parallel,
                                  devices_per_pod=cluster.alive_devices)
            step = checkpoint_mgr.latest_step() or 0


class HostFailure(RuntimeError):
    def __init__(self, host: int):
        super().__init__(f"host {host} failed")
        self.host = host
