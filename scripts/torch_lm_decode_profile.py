#!/usr/bin/env python3
"""Where an LM decode step's time goes: host clock against device time for
the port's ``LM.decode_step`` on one NVIDIA card, at a full config.

    python3 scripts/torch_lm_decode_profile.py [--arch smollm-360m] [--steps 5]

The arch's full config (bf16) is built with ``LM.init`` from a seeded
generator.  For batch 4 and 32, after 3 warm-up steps, ``--steps`` decode
steps are timed one by one on the host clock, each ending in a
synchronize; then one more step runs under ``torch.profiler``.  Each batch
prints one JSON line: the host milliseconds per step (all and median), the
device milliseconds of the profiled step (the sum of its kernels, copies
and memsets) and their share of its host time (the device's busy share),
the kernel launches of the step (``cudaLaunchKernel`` and
``cuLaunchKernelEx`` calls) and per layer, the host milliseconds the
profiler saw on the CPU side, and the ten operators with the most
self-CPU time.  Every line carries the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernelEx")
BATCHES = (4, 32)
WARMUP = 3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    card = chip_smoke.phase_device()
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    max_len = WARMUP + args.steps + 1
    for batch in BATCHES:
        state = lm.init_decode_state(params, batch, max_len=max_len)
        token = torch.zeros((batch,), dtype=torch.int32, device=dev)
        for _ in range(WARMUP):
            _, state = lm.decode_step(params, state, token)
        torch.cuda.synchronize()
        host = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            _, state = lm.decode_step(params, state, token)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, state = lm.decode_step(params, state, token)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
        events = prof.events()
        device_us = sum(e.device_time_total for e in events
                        if e.device_type == DeviceType.CUDA)
        launches = sum(1 for e in events if e.name in LAUNCH_CALLS)
        ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
        print(json.dumps(dict(
            arch=cfg.name, dtype=cfg.param_dtype, batch=batch,
            host_ms_per_step=statistics.median(host), host_ms_all=host,
            profiled_step_host_ms=step_ms, device_ms=device_us / 1e3,
            device_busy_share=device_us / 1e3 / step_ms,
            launches_per_step=launches,
            launches_per_layer=launches / cfg.n_layers,
            profiled_cpu_ms=sum(a.self_cpu_time_total for a in ops) / 1e3,
            top_self_cpu_ms={a.key: a.self_cpu_time_total / 1e3
                             for a in ops[:10]},
            card=card)), flush=True)


if __name__ == "__main__":
    main()
