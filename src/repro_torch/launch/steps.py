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
trees and writes none it is given.

The shaped inputs of the dry run (``shaped_params``, ``shaped_opt_state``,
``batch_specs``, ``shaped_decode_state``) are ``meta`` DTensors on a
``DeviceMesh``, placed by the reference's rules: each holds its global
shape and dtype and its local shard's shape, and nothing is allocated.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                      distribute_tensor)
from torch.utils.checkpoint import checkpoint

from ..models import LM, ModelConfig
from ..models.act_sharding import constrain, lift, local, shard_start
from ..optim import AdamWConfig, adamw_init, adamw_update
from ..prng import PRNGKey
from ..tree import flatten_with_paths, unflatten
from .mesh import axis_sizes, dp_axes
from .sharding import (P, _div, batch_pspec, distribute_tree,
                       param_shardings, placements, safe_spec)

__all__ = ["SHAPES", "shape_applicable", "make_loss_fn", "loss_and_grads",
           "make_train_step", "pick_n_micro", "make_prefill_step",
           "make_decode_step", "params_shape", "shaped_params",
           "shaped_opt_state", "batch_specs", "shaped_decode_state",
           "LM", "ModelConfig", "AdamWConfig", "adamw_init", "adamw_update",
           "dp_axes", "P", "batch_pspec", "param_shardings"]

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
    logp = constrain(torch.log_softmax(logits, dim=-1), "dp", None, "tp")
    picked = constrain(_pick(logp, labels[..., None].long()),
                       "dp", None, None)
    nll = -picked.sum()
    zsum = torch.square(torch.logsumexp(logits, dim=-1)).sum()
    return nll, zsum


def _pick(logp: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``torch.gather(logp, -1, ids)``.  From vocab-sharded DTensor
    log-probs each position picks the ids its columns hold and gives
    zeros for the rest, a partial sum the caller reduces (DTensor's own
    gather gives a masked partial, whose reduction has no gradient)."""
    if not isinstance(logp, DTensor):
        return torch.gather(logp, -1, ids)
    start, vocab = shard_start(logp, logp.ndim - 1)
    rows = [Replicate() if i in vocab else p
            for i, p in enumerate(logp.placements)]
    ids = ids.redistribute(logp.device_mesh, rows)
    n = logp.to_local().shape[-1]

    def pick(lp, idx):
        idx = idx - start
        hit = (idx >= 0) & (idx < n)
        return torch.gather(lp, -1, idx.clamp(0, n - 1)) * hit.to(lp.dtype)

    return local(pick, [Partial() if i in vocab else p
                        for i, p in enumerate(rows)], logp, ids)


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
        nll_tot = lift(torch.zeros((), dtype=torch.float32,
                                   device=hidden.device), hidden)
        z_tot = lift(torch.zeros((), dtype=torch.float32,
                                 device=hidden.device), hidden)
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
            gsum = [torch.zeros_like(t, dtype=torch.float32)
                    for t in leaves]
            nll_sum = lift(torch.zeros((), dtype=torch.float32,
                                       device=leaves[0].device), leaves[0])
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


# --------------------------------------------------------- shaped inputs ---
def _meta(shape, dtype, mesh, spec) -> DTensor:
    """A ``meta`` DTensor of global ``shape`` placed on ``mesh`` by
    ``spec``."""
    return distribute_tensor(torch.empty(shape, dtype=dtype, device="meta"),
                             mesh, placements(spec, mesh), src_data_rank=None)


def params_shape(model: LM) -> Any:
    """The parameter tree on ``meta``: shapes and dtypes, nothing drawn."""
    return model.init(PRNGKey(0), device="meta")


def shaped_params(model: LM, mesh) -> Any:
    """The parameters as ``meta`` DTensors placed by ``param_shardings``."""
    shapes = params_shape(model)
    return distribute_tree(shapes, param_shardings(shapes, mesh, model.cfg),
                           mesh)


def shaped_opt_state(model: LM, mesh, opt_cfg: AdamWConfig) -> Any:
    """AdamW's state as ``meta`` DTensors: m and v shard exactly like the
    params (ZeRO); step is replicated."""
    shapes = params_shape(model)
    specs = param_shardings(shapes, mesh, model.cfg)
    o_shape = adamw_init(shapes, opt_cfg)
    return type(o_shape)(step=_meta((), torch.int32, mesh, P()),
                         m=distribute_tree(o_shape.m, specs, mesh),
                         v=distribute_tree(o_shape.v, specs, mesh))


def batch_specs(cfg: ModelConfig, mesh, shape: str) -> Dict[str, Any]:
    """The cell's batch as ``meta`` DTensors: the batch dim over the
    data-parallel axes where it divides them."""
    info = SHAPES[shape]
    b, s = info["batch"], info["seq"]
    dp = batch_pspec(mesh)
    bspec = dp if b % max(1, _dp_total(mesh)) == 0 else P(None)
    out = {
        "tokens": _meta((b, s), torch.int32, mesh, P(*bspec, None)),
        "labels": _meta((b, s), torch.int32, mesh, P(*bspec, None)),
    }
    if cfg.family == "encdec":
        out["frames"] = _meta((b, cfg.encoder_seq, cfg.d_model), cfg.cdtype,
                              mesh, P(*bspec, None, None))
    if cfg.family == "vlm":
        out["patch_embeds"] = _meta((b, cfg.n_patches, cfg.d_model),
                                    cfg.cdtype, mesh, P(*bspec, None, None))
    if info["kind"] != "train":
        out.pop("labels")
    return out


def _dp_total(mesh) -> int:
    sizes = axis_sizes(mesh)
    t = 1
    for a in dp_axes(mesh):
        t *= sizes[a]
    return t


def shaped_decode_state(model: LM, cfg: ModelConfig, mesh, shape: str):
    """The cell's ``DecodeState`` as ``meta`` DTensors (a KV cache's length
    and the position stay Python ints).

    Layout rules (all divisibility-checked by ``safe_spec``):
    * KV caches (R,B,S,KV,hd): batch over DP; KV heads over `model` when
      divisible, else the *sequence* dim over `model` (+`data` too when the
      batch can't shard — the 500k-token distributed-KV layout).
    * Mamba h (R,B,d_in,N): d_in over `model`.  Conv window likewise.
    * mLSTM/sLSTM states: small; batch over DP only.
    """
    info = SHAPES[shape]
    b, s = info["batch"], info["seq"]
    dp = dp_axes(mesh)

    frames = None
    if cfg.family == "encdec":
        frames = torch.empty((b, cfg.encoder_seq, cfg.d_model),
                             dtype=cfg.cdtype, device="meta")
    state_shape = model.init_decode_state(params_shape(model), batch=b,
                                          max_len=s, frames=frames)

    kv_heads_shardable = _div(mesh, cfg.n_kv_heads, "model")
    batch_shardable = _div(mesh, b, dp)
    seq_axes = "model" if batch_shardable else ("data", "model")

    def assign(name, leaf):
        shp = tuple(leaf.shape)
        if name.endswith("position") or len(shp) == 0:
            return P()
        body = shp[1:]  # all stacked leaves carry a leading n_repeats dim
        if len(body) == 4 and body[-1] == cfg.hd:          # KV cache
            if kv_heads_shardable:
                ps = safe_spec(mesh, body, dp, None, "model", None)
            else:
                ps = safe_spec(mesh, body, dp, seq_axes, None, None)
        elif len(body) == 4:                               # mLSTM C
            ps = safe_spec(mesh, body, dp, None, "model", None)
        elif len(body) == 3 and body[-1] == cfg.hd:        # cross K/V
            ps = safe_spec(mesh, body, dp, None, None)
        elif (len(body) == 3 and cfg.mamba is not None
              and body[-1] == cfg.mamba.d_state):          # mamba h
            ps = safe_spec(mesh, body, dp, "model", None)
        elif len(body) == 3:                               # conv window/mLSTM n
            ps = safe_spec(mesh, body, dp, None, "model")
        elif len(body) == 2:                               # sLSTM states
            ps = safe_spec(mesh, body, dp, None)
        else:
            ps = P(*([None] * len(body)))
        return P(None, *ps)

    paths, leaves = flatten_with_paths(state_shape)
    return unflatten(state_shape, [
        _meta(tuple(t.shape), t.dtype, mesh, assign(p, t))
        if isinstance(t, torch.Tensor) else t
        for p, t in zip(paths, leaves)])
