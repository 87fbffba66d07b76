#!/usr/bin/env python3
"""Where a serve call's time goes: host clock against device time for the
port's ``ServingRuntime`` on one NVIDIA card, at SSB SF 10.

    python3 scripts/torch_serving_profile.py [--calls 50]

For P1 (fused linear, three arms) and P3 (nonfused tree) under
``serve_backend`` "kernel" and "torch", ``--calls`` requests of 8 and of
512 random keys are served after a warm-up that has had the bucket's first
call.  Each (query, backend, serve, batch) prints one JSON line: the
host-clock milliseconds per call (each call ends in a synchronize) without
and with ``torch.profiler``, the device milliseconds per call (the sum of
the profiled kernels, copies and memsets), their ratio under the profiler
(the device's busy share), the device operations per call, the p50 of
``latency_stats()`` over the unprofiled calls, and the host milliseconds
per call of the key checks, the padding and the copy to the device alone
(``_normalize`` + ``_admit``), the part of a sample that comes before the
online program.  Two last
lines time the enqueue alone (no synchronize) of the fused gather-sum at
64 rows: the kernel's wrapper against the plain version, microseconds per
call.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SF = 10
CASES = (("P1.linear.year", "fused"), ("P3.tree.year", "nonfused"))


def _device_events(prof):
    """The profiled device-side events (kernels, copies, memsets)."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=50)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.core.query import compile_serving
    from repro_torch.data import QUERY_IR, generate_ssb
    from repro_torch.kernels import fused_star_gather, fused_star_gather_ref

    chip_smoke.phase_device()
    chip_smoke.phase_build()
    dev = torch.device("cuda")
    tables = generate_ssb(sf=SF, scale=1.0, seed=0, device=dev).tables()
    rng = np.random.default_rng(0)
    for name, backend in CASES:
        q = QUERY_IR[name]()
        for serve in ("kernel", "torch"):
            rt = compile_serving(tables, q, backend=backend,
                                 serve_backend=serve)
            for n in (8, 512):
                reqs = [{a.fk_col: rng.integers(
                    0, int(tables[a.table].nvalid), size=n).astype(np.int32)
                    for a in q.arms} for _ in range(args.calls)]
                for r in reqs[:3]:          # every bucket's first call, then
                    rt.serve(r)             # a warm one
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for r in reqs:
                    rt.serve(r)
                plain_host_ms = (time.perf_counter() - t0) * 1e3 / args.calls
                latency_p50 = rt.latency_stats()[n]["p50"]
                t0 = time.perf_counter()
                for r in reqs:
                    rt._admit(rt._normalize(r))
                torch.cuda.synchronize()
                admit_ms = (time.perf_counter() - t0) * 1e3 / args.calls
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    for r in reqs:
                        rt.serve(r)
                    host_ms = (time.perf_counter() - t0) * 1e3 / args.calls
                dev_events = _device_events(prof)
                device_us = sum(e.device_time_total for e in dev_events)
                device_ms = device_us / 1e3 / args.calls
                print(json.dumps(dict(
                    query=name, backend=backend, serve=rt.serve_backend,
                    batch=n, calls=args.calls,
                    host_ms_per_call_unprofiled=plain_host_ms,
                    latency_p50_ms=latency_p50,
                    normalize_admit_ms_per_call=admit_ms,
                    host_ms_per_call=host_ms,
                    device_ms_per_call=device_ms,
                    device_busy_share=device_ms / host_ms,
                    device_ops_per_call=len(dev_events) / args.calls)),
                    flush=True)
    # Enqueue cost of the fused gather-sum alone, at 64 rows.
    rt = compile_serving(tables, QUERY_IR["P1.linear.year"](),
                         backend="fused", serve_backend="kernel")
    ptrs = torch.zeros((3, 64), dtype=torch.int32, device=dev)
    found = torch.ones((3, 64), dtype=torch.bool, device=dev)
    parts = [a.table for a in rt._arms]
    for label, fn in (("kernel wrapper", fused_star_gather),
                      ("plain", fused_star_gather_ref)):
        for _ in range(10):
            fn(ptrs, found, parts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn(ptrs, found, parts)
        enqueue_us = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        print(json.dumps(dict(op="fused_star_gather 64 rows", path=label,
                              enqueue_us_per_call=enqueue_us)), flush=True)


if __name__ == "__main__":
    main()
