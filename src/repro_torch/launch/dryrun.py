"""Dry run: trace every (arch × shape × mesh) cell of the LM on a
production mesh, with no card and no memory (port of
``repro.launch.dryrun``).

The reference forces 512 host devices and lowers and compiles each cell.
The port stands one process for every position instead: a ``fake``
process group of 256 or 512 ranks (this process is rank 0), a
``DeviceMesh`` of the production shape over it, and the cell's inputs as
``meta`` DTensors placed by the sharding rules.  Per cell:

  1. build the full config and its shaped inputs (``steps.py``: params,
     AdamW state, batch, decode state — global shapes, local ``meta``
     shards, nothing allocated),
  2. run the port's step once — ``make_train_step`` (with
     ``pick_n_micro``), ``make_prefill_step`` or ``make_decode_step`` —
     with the activation constraints on, under ``hlo_analysis.CostMode``,
  3. record the live local bytes (argument, output, and temp = peak live
     less arguments), the per-device costs and their H100 roofline terms
     (``roofline.py``), the trace time, and ``FlopCounterMode``'s count,
     to ``<outdir>/<cell>.json``.

A process has one default process group, so the fake group is set up
here, when a cell runs, never at import; a different-sized fake group is
torn down first.  Run the module as its own process (tests do so in a
subprocess).

``--mesh smoke`` runs each arch's smoke config on a (4, 4) fake group
instead: the same code path in seconds, for CPU checks.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh both] [--skip-existing]
  python -m repro_torch.launch.dryrun --arch smollm-360m --mesh smoke
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from ..configs import arch_ids, get_config, get_smoke_config
from ..models import LM
from ..models.act_sharding import (clear_activation_sharding,
                                   set_activation_sharding)
from ..optim import AdamWConfig
from . import steps as S
from .hlo_analysis import trace_costs
from .mesh import (dp_axes, make_device_mesh, make_production_mesh,
                   production_mesh_shape)
from .roofline import analyze_cell
from .sharding import safe_spec

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "dryrun_out")

#: Mesh kind → (shape, axis names).
MESHES = {"pod": production_mesh_shape(),
          "multipod": production_mesh_shape(multi_pod=True),
          "smoke": ((4, 4), ("data", "model"))}

__all__ = ["RESULTS_DIR", "MESHES", "cell_name", "lower_cell",
           "cell_step", "trace_cell", "run_cell", "main", "arch_ids", "get_config", "LM",
           "AdamWConfig", "make_production_mesh", "analyze_cell"]


def cell_name(arch: str, shape: str, mesh: str) -> str:
    return f"{arch}__{shape}__{mesh}".replace("/", "_")


def fake_group(world_size: int, rank: int = 0) -> None:
    """Make the default process group a ``fake`` one of ``world_size``
    ranks, this process rank ``rank``, tearing down a fake group of
    another size or rank; any other group in force is an error."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and \
                dist.get_world_size() == world_size and \
                dist.get_rank() == rank:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs its own process: a "
                               f"{dist.get_backend()!r} group is in force")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(),
                            world_size=world_size, rank=rank)


def cell_step(cfg, shape: str, mesh, opt_state_dtype: str | None = None):
    """(step, args) of one cell: the port's step for ``shape`` (a key of
    ``steps.SHAPES``) and its shaped inputs on ``mesh`` (a ``DeviceMesh``
    over the process group in force).  Run it with the activation
    constraints set (``set_activation_sharding``)."""
    model = LM(cfg)
    info = S.SHAPES[shape]
    if info["kind"] == "train":
        opt_cfg = AdamWConfig(
            state_dtype=opt_state_dtype
            if opt_state_dtype is not None else
            ("bfloat16" if cfg.n_params() > 5e10 else None))
        n_micro = S.pick_n_micro(cfg, mesh, info["batch"])
        return (S.make_train_step(model, cfg, opt_cfg, n_micro=n_micro),
                (S.shaped_params(model, mesh),
                 S.shaped_opt_state(model, mesh, opt_cfg),
                 S.batch_specs(cfg, mesh, shape)))
    if info["kind"] == "prefill":
        return (S.make_prefill_step(model, cfg),
                (S.shaped_params(model, mesh),
                 S.batch_specs(cfg, mesh, shape)))
    b = info["batch"]
    token = S._meta((b,), torch.int32, mesh,
                    safe_spec(mesh, (b,), dp_axes(mesh)))
    return (S.make_decode_step(model, cfg),
            (S.shaped_params(model, mesh),
             S.shaped_decode_state(model, cfg, mesh, shape), token))


def trace_cell(cfg, shape: str, mesh, opt_state_dtype: str | None = None):
    """Run one cell's step (``cell_step``) once under the cost analyzer,
    with the activation constraints on.  Returns ``trace_costs``' (output,
    costs, memory stats, FlopCounterMode flops)."""
    step, args = cell_step(cfg, shape, mesh, opt_state_dtype)
    set_activation_sharding(dp_axes(mesh), "model", mesh)
    try:
        return trace_costs(step, *args)
    finally:
        clear_activation_sharding()


def lower_cell(arch: str, shape: str, multi_pod: bool,
               opt_state_dtype: str | None = None, mesh_kind: str = None):
    """Trace one cell on the production mesh (or the ``MESHES`` entry
    ``mesh_kind``; ``"smoke"`` takes the smoke config); returns ((costs,
    memory stats, FlopCounterMode flops), cfg, mesh), or (None, cfg, why)
    for a shape the arch does not run."""
    mesh_kind = mesh_kind or ("multipod" if multi_pod else "pod")
    cfg = get_smoke_config(arch) if mesh_kind == "smoke" else \
        get_config(arch)
    ok, why = S.shape_applicable(cfg, shape)
    if not ok:
        return None, cfg, why
    mesh_shape, axes = MESHES[mesh_kind]
    fake_group(int(torch.tensor(mesh_shape).prod()))
    mesh = make_device_mesh(mesh_shape, axes)
    _, costs, mem, flops = trace_cell(cfg, shape, mesh, opt_state_dtype)
    return (costs, mem, flops), cfg, mesh


def run_cell(arch: str, shape: str, mesh_kind: str, outdir: str,
             skip_existing: bool = False) -> dict:
    os.makedirs(outdir, exist_ok=True)
    name = cell_name(arch, shape, mesh_kind)
    path = os.path.join(outdir, name + ".json")
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    t0 = time.time()
    record = {"arch": arch, "shape": shape, "mesh": mesh_kind,
              "n_devices": int(torch.tensor(MESHES[mesh_kind][0]).prod())}
    try:
        traced, cfg, info = lower_cell(arch, shape,
                                       mesh_kind == "multipod",
                                       mesh_kind=mesh_kind)
        if traced is None:
            record["status"] = "skipped"
            record["reason"] = info
        else:
            costs, mem, flops = traced
            roof = analyze_cell(arch, shape, mesh_kind,
                                record["n_devices"], cfg, costs)
            record.update({
                "status": "ok",
                "compile_s": time.time() - t0,       # the trace time
                "memory": {
                    "argument_bytes": mem.argument_bytes,
                    "output_bytes": mem.output_bytes,
                    "temp_bytes": mem.temp_bytes,
                    "peak_bytes": mem.peak_bytes,
                },
                "flop_counter": {"flops": flops},
                "roofline": roof.to_json(),
            })
    except Exception as e:  # a failed cell is a bug — record it loudly
        record["status"] = "failed"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    status = record["status"]
    extra = (f" {record.get('compile_s', 0):.0f}s "
             f"bottleneck={record.get('roofline', {}).get('bottleneck', '-')}"
             if status == "ok" else
             f" ({record.get('reason', record.get('error', ''))[:120]})")
    print(f"[dryrun] {name}: {status}{extra}", flush=True)
    return record


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(S.SHAPES) + [None])
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both", "smoke"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--outdir", default=os.path.abspath(RESULTS_DIR))
    args = ap.parse_args()

    archs = arch_ids() if (args.all or args.arch is None) else [args.arch]
    shapes = list(S.SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    n_fail = 0
    try:
        for arch in archs:
            for shape in shapes:
                for mesh_kind in meshes:
                    rec = run_cell(arch, shape, mesh_kind, args.outdir,
                                   skip_existing=args.skip_existing)
                    n_fail += rec["status"] == "failed"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
