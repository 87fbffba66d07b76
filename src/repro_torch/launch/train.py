"""Training driver: data pipeline → train loop → checkpoints (port of
``repro.launch.train``).

Runs on the card unless given ``device="cpu"`` (``--device cpu``).
Fault-tolerance posture, as the reference's:
* resume from the latest committed checkpoint (params, optimizer, data
  iterator state),
* async checkpoint every ``ckpt_every`` steps,
* per-step wall time (ending in a synchronize on the card) fed to the
  StragglerMonitor.

The mesh is the reference's host mesh, one position on the run's device
(``production`` asks for the 256-card production mesh, which raises with
fewer cards).  Parameters are drawn whole on the run's device: the
reference places them by ``param_shardings``, which a one-position mesh
does not need.

Usage (CPU example scale):
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \
      --steps 20 --batch 8 --seq 128
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke_config
from ..data import TokenPipeline, TokenPipelineConfig, make_global_batch
from ..device import DeviceLike, resolve_device
from ..models import LM
from ..models.act_sharding import (clear_activation_sharding,
                                   set_activation_sharding)
from ..optim import AdamWConfig, adamw_init
from ..runtime import StragglerMonitor
from . import steps as S
from .mesh import dp_axes, make_host_mesh, make_production_mesh
from .sharding import batch_pspec


def train(arch: str, smoke: bool, steps: int, batch: int, seq: int,
          ckpt_dir: str, ckpt_every: int, production: bool = False,
          lr: float = 3e-4, log_every: int = 10, device: DeviceLike = None):
    """Train ``arch`` for ``steps`` steps (resuming from ``ckpt_dir``'s
    latest checkpoint); returns the per-step NLL of the steps run."""
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    model = LM(cfg)
    mesh = make_production_mesh() if production else make_host_mesh(
        device=dev)
    set_activation_sharding(dp_axes(mesh), "model", mesh)
    opt_cfg = AdamWConfig(lr=lr)
    step_fn = S.make_train_step(model, cfg, opt_cfg)

    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, global_batch=batch, seq_len=seq))
    mgr = CheckpointManager(ckpt_dir, keep=3)
    straggler = StragglerMonitor([pipe.pi])
    bspec = batch_pspec(mesh)

    try:
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            device=dev)
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
                batch_arrays["frames"] = torch.zeros(
                    (tokens.shape[0], cfg.encoder_seq, cfg.d_model),
                    dtype=torch.float32, device=dev)
            if cfg.family == "vlm":
                batch_arrays["patch_embeds"] = torch.zeros(
                    (tokens.shape[0], cfg.n_patches, cfg.d_model),
                    dtype=torch.float32, device=dev)
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 batch_arrays)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.perf_counter() - t0
            straggler.record_step({pipe.pi: dt})
            if step % log_every == 0 or step == steps - 1:
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
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
                    help="torch device (default: the card)")
    args = ap.parse_args()
    losses = train(args.arch, args.smoke, args.steps, args.batch, args.seq,
                   args.ckpt_dir, args.ckpt_every, args.production, args.lr,
                   device=args.device)
    if losses:
        print(f"[train] done; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    else:
        print("[train] done; no step left to run")


if __name__ == "__main__":
    main()
