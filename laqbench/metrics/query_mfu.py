"""The whole query's share of the card's peak: each query's least time
by its roofline (``roofline.query_work``: the larger of its bytes at the
HBM peak and its operations at the float32 peak), summed over the window's
queries, over the sum of their measured latencies.  Queries inside the
profiled slice are left out, as the profiler slows them."""
from laqbench.roofline import least_s


def read(run):
    if not run.least or not run.names:
        return None
    pairs = list(zip(run.names, run.latencies_ms))[run.profiled:]
    spent = sum(ms for _, ms in pairs) / 1e3
    if not pairs or spent <= 0:
        return None
    least = sum(least_s(*run.least[q])[0] for q, _ in pairs)
    return 100.0 * least / spent
