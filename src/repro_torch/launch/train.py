"""Training driver: data pipeline → train loop → checkpoints (port of
``repro.launch.train``).

Runs on the card unless given ``device="cpu"`` (``--device cpu``).
Fault-tolerance posture, as the reference's:
* resume from the latest committed checkpoint (params, optimizer, data
  iterator state),
* async checkpoint every ``ckpt_every`` steps,
* per-step wall time (ending in a synchronize on the card) fed to the
  StragglerMonitor.

The mesh is the reference's host mesh over whatever devices exist.
Without a ``torch.distributed`` group that is one position on the run's
device (``production`` asks for the 256-card production mesh, which
raises with fewer cards), and the driver runs on plain tensors.  With
the default process group initialised (``main`` starts one from a
``torchrun`` environment) it is a ``DeviceMesh`` over the group's ranks:
the parameters are placed by ``param_shardings`` (``distribute_tree``),
the AdamW moments on the same specs with ``step`` replicated, the batch
is built from each rank's slice of it (``make_global_batch``; each
position along the data axes reads its own rows), checkpoints hold each
rank's shards and a resume puts them back on the same placements.  The
parameters are drawn under the reference's key, ``PRNGKey(0)``, with its
threefry PRNG (``repro_torch.prng``): each rank draws only its own shard
of every leaf, equal bit for bit to the same slice of the whole draw, and
the AdamW moments are made on the parameters' placements, so no rank
ever holds a whole leaf.

Usage (CPU example scale):
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \
      --steps 20 --batch 8 --seq 128
Four CPU ranks (``gloo``):
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --device cpu --smoke --steps 20 --batch 8 --seq 128
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke_config
from ..data import TokenPipeline, TokenPipelineConfig, make_global_batch
from ..device import DeviceLike, resolve_device
from ..models import LM
from ..models.act_sharding import (clear_activation_sharding,
                                   set_activation_sharding)
from ..optim import AdamWConfig, AdamWState, adamw_init
from ..prng import PRNGKey
from ..runtime import StragglerMonitor
from . import steps as S
from .mesh import dp_axes, dp_position, make_host_mesh, make_production_mesh
from .sharding import P, batch_pspec, distribute_tree, param_shardings


def _whole(x):
    """A metric's value: a DTensor's (a partial sum on a mesh) reduced."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def train(arch: str, smoke: bool, steps: int, batch: int, seq: int,
          ckpt_dir: str, ckpt_every: int, production: bool = False,
          lr: float = 3e-4, log_every: int = 10, device: DeviceLike = None):
    """Train ``arch`` for ``steps`` steps (resuming from ``ckpt_dir``'s
    latest checkpoint); returns the per-step NLL of the steps run.  On a
    process group every rank calls it alike (module docstring)."""
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    model = LM(cfg)
    mesh = make_production_mesh() if production else make_host_mesh(
        device=dev)
    set_activation_sharding(dp_axes(mesh), "model", mesh)
    opt_cfg = AdamWConfig(lr=lr)
    step_fn = S.make_train_step(model, cfg, opt_cfg)

    data_index, data_count = dp_position(mesh)
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, global_batch=batch, seq_len=seq),
        process_index=data_index, process_count=data_count)
    mgr = CheckpointManager(ckpt_dir, keep=3)
    rank = dist.get_rank() if dist.is_initialized() else 0
    straggler = StragglerMonitor([rank])
    bspec = batch_pspec(mesh)

    try:
        on_mesh = isinstance(mesh, DeviceMesh)
        if on_mesh:
            specs = param_shardings(S.params_shape(model), mesh, cfg)
            state_specs = AdamWState(step=P(), m=specs, v=specs)
            params = model.init(PRNGKey(0), device=dev, mesh=mesh,
                                shardings=specs)
            # The moments are DTensors on the parameters' placements; this
            # only replicates the step counter.
            opt_state = distribute_tree(adamw_init(params, opt_cfg),
                                        state_specs, mesh)
        else:
            params = model.init(PRNGKey(0), device=dev)
            opt_state = adamw_init(params, opt_cfg)

        start = 0
        latest = mgr.latest_step()
        if latest is not None:
            (params, opt_state), extras = mgr.restore(
                latest, (params, opt_state))
            pipe.restore(extras["pipeline"])
            start = latest
            print(f"[train] resumed from step {latest}")

        pipe.start()
        losses = []
        for step in range(start, steps):
            t0 = time.perf_counter()
            tokens, labels = pipe.next()
            batch_arrays = {"tokens": make_global_batch(tokens, mesh, bspec),
                            "labels": make_global_batch(labels, mesh, bspec)}
            if cfg.family == "encdec":
                batch_arrays["frames"] = make_global_batch(np.zeros(
                    (tokens.shape[0], cfg.encoder_seq, cfg.d_model),
                    np.float32), mesh, bspec)
            if cfg.family == "vlm":
                batch_arrays["patch_embeds"] = make_global_batch(np.zeros(
                    (tokens.shape[0], cfg.n_patches, cfg.d_model),
                    np.float32), mesh, bspec)
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 batch_arrays)
            if on_mesh:
                # The step hands back its new leaves as partial sums over
                # the data axes (the gradients' reduction, deferred):
                # reduce them now, so every step (and every checkpoint)
                # starts from the placements above.
                params = distribute_tree(params, specs, mesh)
                opt_state = distribute_tree(opt_state, state_specs, mesh)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            loss = float(_whole(metrics["loss"]))
            losses.append(loss)
            dt = time.perf_counter() - t0
            straggler.record_step({rank: dt})
            if step % log_every == 0 or step == steps - 1:
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(_whole(metrics['grad_norm'])):.3f} "
                      f"{dt*1e3:.0f}ms", flush=True)
            if ckpt_every and (step + 1) % ckpt_every == 0:
                mgr.save_async(step + 1, (params, opt_state),
                               extras={"pipeline": pipe.state()})
        return losses
    finally:
        pipe.stop()
        mgr.wait()
        clear_activation_sharding()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production", action="store_true",
                    help="use the 256-card production mesh")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card); under a "
                         "torchrun environment 'cpu' or the card "
                         "cuda:LOCAL_RANK")
    args = ap.parse_args()
    device = args.device
    group = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if group:
        # A torchrun-style environment: RANK, WORLD_SIZE, LOCAL_RANK and
        # MASTER_ADDR/MASTER_PORT for the env:// rendezvous.
        if device is not None and torch.device(device).type == "cpu":
            dist.init_process_group("gloo", init_method="env://")
        else:
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(device)
            dist.init_process_group("nccl", init_method="env://",
                                    device_id=device)
    try:
        losses = train(args.arch, args.smoke, args.steps, args.batch,
                       args.seq, args.ckpt_dir, args.ckpt_every,
                       args.production, args.lr, device=device)
    finally:
        if group:
            dist.destroy_process_group()
    if losses:
        print(f"[train] done; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    else:
        print("[train] done; no step left to run")


if __name__ == "__main__":
    main()
