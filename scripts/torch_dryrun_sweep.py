#!/usr/bin/env python3
"""The port's dry run over every (arch × shape × mesh) cell, several
processes at a time.

    python3 scripts/torch_dryrun_sweep.py [--mesh both] [--jobs 6]
        [--outdir dryrun_out] [--archs a,b,...]

Starts one ``python -m repro_torch.launch.dryrun --arch A --mesh M``
process per arch and mesh (each runs A's four shapes on its own ``fake``
process group), ``--jobs`` at a time, largest archs first, and waits for
them.  Each cell's record lands in ``--outdir/<arch>__<shape>__<mesh>.json``
as the dry run writes it.  Then it prints one JSON line per cell (status,
trace seconds, per-device argument/temp bytes, flops, bottleneck, error)
and a last line with the counts by status, the wall time, the host's CPU
count and, where ``nvidia-smi`` answers, the card's name and power limit
(the dry run itself runs on the host and needs no card).  Exits non-zero
if a cell failed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
#: Largest first, so the longest traces start first.
ORDER = ("jamba-1.5-large-398b", "dbrx-132b", "pixtral-12b", "gemma-7b",
         "minitron-4b", "qwen2-moe-a2.7b", "llama3.2-1b", "smollm-360m",
         "xlstm-125m", "whisper-tiny")


def card() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--outdir", default=str(ROOT / "dryrun_out"))
    ap.add_argument("--archs", default=",".join(ORDER))
    args = ap.parse_args()
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    archs = args.archs.split(",")
    todo = [(a, m) for a in archs for m in meshes]
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    t0 = time.perf_counter()
    running = []
    logs = Path(args.outdir) / "logs"
    logs.mkdir(parents=True, exist_ok=True)
    try:
        while todo or running:
            while todo and len(running) < args.jobs:
                arch, mesh = todo.pop(0)
                log = open(logs / f"{arch}__{mesh}.log", "w")
                running.append((subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--mesh", mesh, "--outdir",
                     args.outdir], env=env, stdout=log,
                    stderr=subprocess.STDOUT), log))
            time.sleep(1)
            for proc, log in [r for r in running if r[0].poll() is not None]:
                log.close()
                running.remove((proc, log))
    finally:
        for proc, log in running:
            proc.kill()
            proc.wait()
            log.close()
    wall = time.perf_counter() - t0
    counts = {}
    for arch in archs:
        for mesh in meshes:
            for path in sorted(Path(args.outdir).glob(
                    f"{arch}__*__{mesh}.json")):
                rec = json.loads(path.read_text())
                roof = rec.get("roofline", {})
                mem = rec.get("memory", {})
                counts[rec["status"]] = counts.get(rec["status"], 0) + 1
                print(json.dumps({
                    "arch": arch, "shape": rec["shape"], "mesh": mesh,
                    "status": rec["status"], "trace_s": rec.get("compile_s"),
                    "argument_bytes": mem.get("argument_bytes"),
                    "temp_bytes": mem.get("temp_bytes"),
                    "flops_per_dev": roof.get("flops_per_dev"),
                    "bottleneck": roof.get("bottleneck"),
                    "error": rec.get("error", rec.get("reason"))}),
                    flush=True)
    print(json.dumps({"cells": counts, "wall_s": wall,
                      "cpus": os.cpu_count(), "jobs": args.jobs,
                      "card": card()}), flush=True)
    if counts.get("failed"):
        raise SystemExit(f"{counts['failed']} cells failed")


if __name__ == "__main__":
    main()
