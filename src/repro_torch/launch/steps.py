"""Step builders: train_step / prefill_step / decode_step (port of
``repro.launch.steps``).

These close over (model, cfg) and are what the drivers (``train.py``,
``serve.py``) call.  Shape cells:

  train_4k     seq 4,096   global_batch 256   → train_step
  prefill_32k  seq 32,768  global_batch 32    → prefill (forward, last logit)
  decode_32k   KV 32,768   global_batch 128   → decode_step (1 new token)
  long_500k    KV 524,288  global_batch 1     → decode_step (sub-quadratic
                                                archs only)

A train step takes the gradients with ``torch.autograd.grad`` over the
parameter leaves in the reference's leaf order (sorted dict keys) and
updates them with ``adamw_update`` under ``torch.no_grad()``; like the
reference's it is functional — it returns new parameter and optimizer
trees and writes none it is given.  The shaped inputs of the AOT dry run
(``shaped_params``, ``shaped_opt_state``, ``batch_specs``,
``shaped_decode_state``) are not ported yet.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..models import LM, ModelConfig
from ..optim import AdamWConfig, adamw_init, adamw_update
from ..tree import flatten_with_paths, unflatten
from .mesh import dp_axes
from .sharding import P, batch_pspec, param_shardings

__all__ = ["SHAPES", "shape_applicable", "make_loss_fn", "loss_and_grads",
           "make_train_step", "pick_n_micro", "make_prefill_step",
           "make_decode_step", "params_shape", "LM", "ModelConfig",
           "AdamWConfig", "adamw_init", "adamw_update", "dp_axes", "P",
           "batch_pspec", "param_shardings"]

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic bodies."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, ("skipped: pure full-attention arch; a 500k KV cache "
                       "presupposes sub-quadratic prefill (DESIGN.md)")
    return True, ""


# ----------------------------------------------------------- loss/steps ----
def _chunk_loss(model: LM, params, h, labels):
    """One sequence chunk's summed NLL and squared log-sum-exp (the
    z-loss term) from its final-normed hidden states."""
    logits = model.unembed(params, h)                # (B, chunk, V) fp32
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long()).sum()
    zsum = torch.square(torch.logsumexp(logits, dim=-1)).sum()
    return nll, zsum


def make_loss_fn(model: LM, cfg: ModelConfig, loss_chunk: int = 1024):
    """Chunked softmax cross-entropy.

    The (B, S, V) fp32 logits are never held whole: a loop over sequence
    chunks of ``loss_chunk`` positions computes each chunk's logits,
    log-softmax, NLL and z-loss under ``torch.utils.checkpoint`` (with
    grad mode on), so autograd keeps each chunk's hidden states and
    recomputes its logits in the backward — peak logits memory drops by
    S/loss_chunk, as the reference's checkpointed scan over chunks does.
    Returns ``loss_fn(params, batch) → (loss + 1e-4·z-loss + 0.01·aux,
    NLL)``."""

    def loss_fn(params, batch):
        kwargs = {}
        if "frames" in batch:
            kwargs["frames"] = batch["frames"]
        if "patch_embeds" in batch:
            kwargs["patch_embeds"] = batch["patch_embeds"]
        hidden, aux = model.forward_hidden(params, batch["tokens"], **kwargs)
        b, s, d = hidden.shape
        chunk = min(loss_chunk, s)
        if s % chunk:
            raise ValueError(f"sequence {s} is not a multiple of the loss "
                             f"chunk {chunk}")
        nll_tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
        z_tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for start in range(0, s, chunk):
            at = slice(start, start + chunk)
            h, labels = hidden[:, at], batch["labels"][:, at]
            if torch.is_grad_enabled():
                nll, zsum = checkpoint(_chunk_loss, model, params, h, labels,
                                       use_reentrant=False)
            else:
                nll, zsum = _chunk_loss(model, params, h, labels)
            nll_tot = nll_tot + nll
            z_tot = z_tot + zsum
        n_tok = b * s
        loss = nll_tot / n_tok
        zloss = 1e-4 * z_tot / n_tok
        return loss + zloss + 0.01 * aux, loss

    return loss_fn


def loss_and_grads(loss_fn, params, batch):
    """(total loss, NLL, grads): the gradients of ``loss_fn``'s total with
    respect to every leaf of ``params`` (a tree of the same structure; a
    leaf the loss does not reach gets zeros, as in jax)."""
    leaves = flatten_with_paths(params)[1]
    req = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        tot, nll = loss_fn(unflatten(params, req), batch)
        grads = torch.autograd.grad(tot, req, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return tot.detach(), nll.detach(), unflatten(params, grads)


def make_train_step(model: LM, cfg: ModelConfig, opt_cfg: AdamWConfig,
                    n_micro: int = 1):
    """Train step with optional microbatched gradient accumulation.

    ``n_micro > 1`` runs the microbatch slices of the global batch one
    after another, accumulating fp32 grads, and divides by ``n_micro`` —
    per-step activation memory drops ~n_micro× at the cost of one fp32
    grad buffer.  Returns ``train_step(params, opt_state, batch) →
    (params, opt_state, metrics)``; ``metrics["loss"]`` is the NLL."""
    loss_fn = make_loss_fn(model, cfg)

    def train_step(params, opt_state, batch):
        if n_micro == 1:
            _, nll, grads = loss_and_grads(loss_fn, params, batch)
        else:
            leaves = flatten_with_paths(params)[1]
            gsum = [torch.zeros(t.shape, dtype=torch.float32,
                                device=t.device) for t in leaves]
            nll_sum = torch.zeros((), dtype=torch.float32,
                                  device=leaves[0].device)
            for i in range(n_micro):
                mb = {k: _micro(x, n_micro, i) for k, x in batch.items()}
                _, nll, g = loss_and_grads(loss_fn, params, mb)
                gsum = [a + x.to(torch.float32)
                        for a, x in zip(gsum, flatten_with_paths(g)[1])]
                nll_sum = nll_sum + nll
            grads = unflatten(params, [g / n_micro for g in gsum])
            nll = nll_sum / n_micro
        with torch.no_grad():
            params, opt_state, metrics = adamw_update(params, grads,
                                                      opt_state, opt_cfg)
        metrics["loss"] = nll
        return params, opt_state, metrics

    return train_step


def _micro(x: torch.Tensor, n_micro: int, i: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n_micro`` equal slices of the batch dim."""
    size = x.shape[0] // n_micro
    return x[i * size:(i + 1) * size]


def pick_n_micro(cfg: ModelConfig, mesh, batch: int) -> int:
    """Microbatch count for the train cells: big models → smallest
    microbatch the DP sharding allows; mid-size → 4; small → 1."""
    dp_total = _dp_total(mesh)
    cap = max(batch // dp_total, 1)
    n = cfg.n_params()
    if n > 5e10:
        return cap
    if n > 3e9:
        return min(4, cap)
    return 1


def make_prefill_step(model: LM, cfg: ModelConfig):
    def prefill_step(params, batch):
        kwargs = {k: batch[k] for k in ("frames", "patch_embeds")
                  if k in batch}
        logits, _ = model.forward(params, batch["tokens"], **kwargs)
        return logits[:, -1]          # next-token logits only

    return prefill_step


def make_decode_step(model: LM, cfg: ModelConfig):
    def decode_step(params, state, token):
        return model.decode_step(params, state, token)

    return decode_step


def params_shape(model: LM) -> Any:
    """The parameter tree on ``meta``: shapes and dtypes, nothing drawn."""
    return model.init(torch.Generator(), device="meta")


def _dp_total(mesh) -> int:
    t = 1
    for a in dp_axes(mesh):
        t *= mesh.shape[a]
    return t
