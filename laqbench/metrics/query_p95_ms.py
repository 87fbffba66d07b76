"""The 95th percentile (nearest rank) of every query's latency in the
window: from a CUDA event recorded as ``run()`` is called to one recorded
once its results are on the host."""
import math


def p95(values):
    s = sorted(values)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)] if s else None


def read(run):
    return p95(run.latencies_ms)
