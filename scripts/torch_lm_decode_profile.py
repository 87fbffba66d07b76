#!/usr/bin/env python3
"""Where an LM decode step's time goes: host clock against device time for
the port's ``LM.decode_step`` on one NVIDIA card, at a full config.

    python3 scripts/torch_lm_decode_profile.py [--arch smollm-360m] [--steps 5]

The arch's full config (bf16; smollm-360m unless ``--arch`` names
another that fits one card, such as qwen2-moe-a2.7b or xlstm-125m) is
built with ``LM.init`` from a seeded generator.  For batch 4 and 32,
after 3 warm-up steps, ``--steps`` decode steps are timed one by one on
the host clock, each ending in a synchronize; then one more step runs
under ``torch.profiler``.  Each batch prints one JSON line: the host
milliseconds per step (all and median), the device milliseconds of the
profiled step (the sum of its kernels, copies and memsets) and their
share of its host time (the device's busy share), the kernel launches of
the step (``cudaLaunchKernel`` and ``cuLaunchKernelEx`` calls) and per
layer, the host milliseconds the profiler saw on the CPU side, the ten
operators with the most self-CPU time and the ten kernels with the most
device time.  For an arch with MoE layers the line adds the MoE layers'
share: the host milliseconds inside their ranges, the device
milliseconds of the kernels that ran inside their device-side ranges, and
the launches (``moe_mlp`` runs inside a ``record_function`` range that
this script adds around it).  Every line carries the card's name and
power limit.
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
MOE_RANGE = "moe_mlp"
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
    from torch.profiler import ProfilerActivity, profile, record_function

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import LM, blocks
    from repro_torch.prng import PRNGKey

    moe_mlp = blocks.moe_mlp

    def traced_moe_mlp(*a, **k):
        with record_function(MOE_RANGE):
            return moe_mlp(*a, **k)

    blocks.moe_mlp = traced_moe_mlp

    card = chip_smoke.phase_device()
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    lm = LM(cfg)
    params = lm.init(PRNGKey(0), device=dev)
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
        # Kernels, copies and memsets: the device events, less the
        # device-side copies of the MoE ranges.
        kernels = [e for e in events if e.device_type == DeviceType.CUDA
                   and e.name != MOE_RANGE]
        device_us = sum(e.device_time_total for e in kernels)
        launches = sum(1 for e in events if e.name in LAUNCH_CALLS)
        ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
        by_kernel = {}
        for e in kernels:
            by_kernel[e.name] = by_kernel.get(e.name, 0) + e.device_time_total
        top_device = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
        moe = {}
        if cfg.moe is not None:
            def spans(kind):
                return [(e.time_range.start, e.time_range.end)
                        for e in events
                        if e.name == MOE_RANGE and e.device_type == kind]

            def inside(t, ranges):
                return any(a <= t < b for a, b in ranges)

            host_spans, dev_spans = spans(DeviceType.CPU), spans(
                DeviceType.CUDA)
            moe = dict(
                moe_layers=len(host_spans),
                moe_host_ms=sum(b - a for a, b in host_spans) / 1e3,
                moe_device_ms=sum(
                    e.device_time_total for e in kernels
                    if inside(e.time_range.start, dev_spans)) / 1e3
                if dev_spans else "not measured",
                moe_launches=sum(
                    1 for e in events if e.name in LAUNCH_CALLS
                    and inside(e.time_range.start, host_spans)))
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
            top_device_ms={k: v / 1e3 for k, v in top_device},
            **moe, card=card)), flush=True)


if __name__ == "__main__":
    main()
