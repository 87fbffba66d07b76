#!/usr/bin/env python3
"""Where a train step's time goes: the port's ``make_train_step`` on one
NVIDIA card at an arch's full config.

    python3 scripts/torch_train_step_profile.py [--arch smollm-360m]
        [--batch 8] [--seq 2048] [--layers N] [--steps 3]

The arch's full config (bf16 parameters, fp32 AdamW moments, remat;
``--layers`` keeps only the first N repeats, for an arch whose full depth
does not fit one card, such as qwen2-moe-a2.7b with ``--layers 2``) is
built with ``LM.init`` from a seeded generator and trained on
``TokenPipeline`` tokens.  After 2 warm-up steps, ``--steps`` steps are
timed one by one on the host clock, each between synchronizes.  Then one
step runs with CUDA events around the flash forward
(``_flash_fwd_impl``, remat recomputes included), the flash backward
(``_flash_bwd_impl``), the loss chunks' forward and recompute
(``_chunk_loss``), the MLPs' forward and recompute (``blocks.mlp``) and
AdamW (``adamw_update``), and one under ``torch.profiler``.  It prints one
JSON line: host ms per step (all and median), tokens/s, peak memory, each
part's device ms and share of the timed step, the profiled step's host
ms, device ms (its kernels, copies and memsets), device busy share,
launches and the ten kernels with the most device time, with the card's
name and power limit.  ``chip_smoke.py``'s ``lm_train_parts`` line is
the CUDA-event split at smollm-360m's defaults.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WARMUP = 2
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernelEx", "cudaLaunchKernelExC")


def train_step_profile(step_fn, params, opt_state, batch):
    """One train step under ``torch.profiler``: host ms, the device ms of
    its kernels, copies and memsets, the launches, the ten kernels with the
    most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.device_time_total for e in kernels)
    by_kernel = {}
    for e in kernels:
        by_kernel[e.name] = by_kernel.get(e.name, 0) + e.device_time_total
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    return dict(profiled_step_host_ms=step_ms,
                device_ms=device_us / 1e3 if kernels else "not measured",
                device_busy_share=(device_us / 1e3 / step_ms
                                   if kernels else "not measured"),
                launches=sum(1 for e in events if e.name in LAUNCH_CALLS),
                top_device_ms={k[:80]: v / 1e3 for k, v in top})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline, TokenPipelineConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import LM
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.prng import PRNGKey

    card = chip_smoke.phase_device()
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_repeats=args.layers)
    lm = LM(cfg)
    params = lm.init(PRNGKey(0), device=dev)
    opt_cfg = AdamWConfig()
    opt = adamw_init(params, opt_cfg)
    step_fn = make_train_step(lm, cfg, opt_cfg)
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, global_batch=args.batch,
        seq_len=args.seq), process_index=0, process_count=1)
    torch.cuda.reset_peak_memory_stats()
    host, losses = [], []
    for i in range(WARMUP + args.steps):
        batch = chip_smoke.train_batch(pipe, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        if i >= WARMUP:
            host.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    batch = chip_smoke.train_batch(pipe, dev)
    step_ms, parts, calls = chip_smoke.train_step_parts(step_fn, params, opt,
                                                        batch)
    prof = train_step_profile(step_fn, params, opt, batch)
    median = statistics.median(host)
    print(json.dumps(dict(
        arch=cfg.name, n_layers=cfg.n_layers, dtype=cfg.param_dtype,
        remat=cfg.remat, batch=args.batch, seq=args.seq,
        host_ms_per_step=median, host_ms_all=host,
        tokens_per_s=args.batch * args.seq / (median / 1e3), losses=losses,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        timed_step_host_ms=step_ms, part_device_ms=parts,
        part_share={k: v / step_ms for k, v in parts.items()},
        part_calls=calls, **prof, card=card)), flush=True)


if __name__ == "__main__":
    main()
