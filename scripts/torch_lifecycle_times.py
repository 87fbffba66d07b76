#!/usr/bin/env python3
"""Delta refresh against a cold compile, step by step, for the port's data
lifecycle on one NVIDIA card, at SSB SF 10 with 1.12x capacity.

    python3 scripts/torch_lifecycle_times.py [--reps 3]

The catalog and the steps are ``chip_smoke.py``'s lifecycle phase
(appends of 0.1, 1 and 10 % of part, 0.1 % of lineorder, an update of
``part.p_size``, deletions from part and lineorder, compaction of part, an
append past part's capacity).  For P1 (fused) and P3 (nonfused tree),
``--reps`` compiled queries and ``--reps`` serving runtimes are built
before the first step, plus one more query that is refreshed under
``torch.profiler``.  After each step every copy refreshes and a cold
``compile_query`` / ``compile_serving`` on the same catalog is timed
``--reps`` times; each time is the host clock around work that ends in a
synchronize, in the order taken (the first copy's refresh is the first
use of that step's code path).  One JSON line per (step, query) gives the
lists, their medians, the refresh line, and the profiled refresh's device
time and its operations with the most device time and the most host time.
The card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _top(prof, key, n=6):
    """The profiled operations with the most ``key`` time (ms, calls)."""
    rows = sorted(prof.key_averages(), key=lambda e: getattr(e, key),
                  reverse=True)[:n]
    return [[e.key, getattr(e, key) / 1e3, e.count] for e in rows
            if getattr(e, key) > 0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.core.query import compile_query, compile_serving
    from repro_torch.data import QUERY_IR

    chip_smoke.phase_device()
    dev = torch.device("cuda")
    cat = chip_smoke.lifecycle_catalog(dev)
    rng = np.random.default_rng(3)
    objects = {}
    for name, backend in chip_smoke.LIFECYCLE_QUERIES:
        q = QUERY_IR[name]()
        objects[name] = (
            [compile_query(cat, q, backend=backend, serve_backend="kernel")
             for _ in range(args.reps + 1)],
            [compile_serving(cat, q, backend=backend, serve_backend="kernel")
             for _ in range(args.reps)])
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for label, table, kind, apply in chip_smoke.lifecycle_steps(cat, rng):
        apply()
        for name, backend in chip_smoke.LIFECYCLE_QUERIES:
            q = QUERY_IR[name]()
            plans, runtimes = objects[name]
            lines = set()
            refresh = []
            for plan in plans[:-1]:
                refresh.append(chip_smoke.host_ms(
                    lambda: lines.add(plan.refresh())))
            with profile(activities=activities) as prof:
                lines.add(plans[-1].refresh())
                torch.cuda.synchronize()
            cold = [chip_smoke.host_ms(lambda: compile_query(
                cat, q, backend=backend, serve_backend="kernel"))
                for _ in range(args.reps)]
            rt_lines = set()
            rt_refresh = [chip_smoke.host_ms(lambda: rt_lines.add(
                rt.refresh())) for rt in runtimes]
            rt_cold = [chip_smoke.host_ms(lambda: compile_serving(
                cat, q, backend=backend, serve_backend="kernel"))
                for _ in range(args.reps)]
            device_events = [e for e in prof.events()
                             if e.device_type.name == "CUDA"]
            print(json.dumps(dict(
                step=label, query=name, route=kind,
                line=sorted(lines), serving_line=sorted(rt_lines),
                refresh_ms=refresh, cold_compile_ms=cold,
                refresh_median_ms=statistics.median(refresh),
                cold_median_ms=statistics.median(cold),
                serving_refresh_ms=rt_refresh, serving_cold_ms=rt_cold,
                serving_refresh_median_ms=statistics.median(rt_refresh),
                serving_cold_median_ms=statistics.median(rt_cold),
                profiled_device_ms=sum(
                    e.device_time_total for e in device_events) / 1e3,
                top_device=_top(prof, "self_device_time_total"),
                top_host=_top(prof, "self_cpu_time_total"))), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
