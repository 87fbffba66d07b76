"""Mixture-of-Experts layer with LAQ-style dispatch (port of
``repro.models.moe``).

The routing decision is a row-matching matrix in the paper's sense: token i
"joins" expert-slot j.  Dispatch is *factored*, as LAQ materializes joins:
a capacity-bounded int32 pointer buffer per expert (the join's
fixed-capacity selection) followed by gathers, never a (T×E×C) one-hot
dispatch tensor.  Combine is the transposed join: a gate-weighted sum of
each token's expert outputs.

Dispatch is **sequence-local**: routing, the stable sort that groups
token-slots by expert, the capacity cut and the gather/combine all carry
the batch dim (B).  Top-k routing with per-expert capacity
C = round_up(S·k/E · cf, 8); tokens over capacity are dropped (GShard
semantics).  A Switch-style load-balance auxiliary loss is returned for
training.

The combine differs from the reference's in form, not in value.  The
reference scatter-adds the slot outputs into a zero buffer
(``out.at[rows, ptr].add``); on the card ``index_add_`` would add them with
atomics in no fixed order, so the same request could decode to different
tokens from run to run.  The port finds each (token, choice) pair's slot
from the same sort, gathers the slot outputs and adds them into zeros in
ascending slot order, in the expert outputs' dtype: the order in which the
reference's scatter applies them on the CPU, and the same on every run.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .act_sharding import constrain
from .common import act_fn, dense_init
from .config import ModelConfig, round_up
from .mlp import init_mlp, mlp


def init_moe(generator, cfg: ModelConfig, device=None):
    """Router (fp32 whatever the config's dtype, as the reference keeps it),
    expert weights and the optional shared MLP, drawn in that order."""
    spec = cfg.moe
    d = cfg.d_model
    gated = cfg.act in ("swiglu", "geglu")
    params = {
        "router": dense_init(generator, (d, spec.n_experts), torch.float32,
                             device=device),
        "wi": dense_init(generator, (spec.n_experts, d,
                                     (2 if gated else 1) * spec.d_expert_ff),
                         cfg.pdtype, device=device),
        "wo": dense_init(generator, (spec.n_experts, spec.d_expert_ff, d),
                         cfg.pdtype, device=device),
    }
    if spec.d_shared_ff:
        params["shared"] = init_mlp(generator, d, spec.d_shared_ff, cfg.act,
                                    cfg.pdtype, device=device)
    return params


def moe_mlp(params, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (y, aux_loss)."""
    spec = cfg.moe
    b, s, d = x.shape
    e, k = spec.n_experts, spec.top_k
    dev = x.device

    # ---- routing (B, S, E) -------------------------------------------------
    logits = torch.einsum("bsd,de->bse", x.to(torch.float32),
                          params["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)      # (B, S, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)

    # Switch-style load-balance aux loss.  The counts are integers, so
    # bincount gives the reference's scatter-add of ones exactly.
    me = probs.mean(dim=(0, 1))                                # (E,)
    ce = torch.bincount(expert_ids.reshape(-1), minlength=e).to(
        torch.float32) / (b * s * k)
    aux = e * torch.sum(me * ce)

    # ---- sequence-local factored dispatch (fixed-capacity join) -----------
    capacity = round_up(max(int(s * k / e * spec.capacity_factor), 1), 8)
    flat_e = expert_ids.reshape(b, s * k)                      # (B, S·k)
    flat_tok = torch.arange(s, dtype=torch.int64, device=dev
                            ).repeat_interleave(k).expand(b, s * k)
    flat_gate = gate_vals.reshape(b, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)         # per row
    sorted_e = torch.gather(flat_e, 1, order)
    sorted_tok = torch.gather(flat_tok, 1, order)
    sorted_gate = torch.gather(flat_gate, 1, order)
    # Rank within expert group = position − first index of the group.
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(s * k, device=dev)[None] - first
    live = rank < capacity
    slot = torch.where(live, sorted_e * capacity + rank, e * capacity)
    # Pointer buffer per row: expert-slot → local token (s = "no row").  The
    # last column is the drop slot; every dropped pair writes it, and it is
    # sliced off.
    ptr = torch.full((b, e * capacity + 1), s, dtype=torch.int64,
                     device=dev).scatter_(1, slot, sorted_tok)[:, :-1]
    gates = torch.zeros((b, e * capacity + 1), dtype=torch.float32,
                        device=dev).scatter_(1, slot, sorted_gate)[:, :-1]

    # ---- expert compute (local gather → grouped GEMM) ----------------------
    valid = ptr < s
    xe = torch.gather(x, 1, torch.clamp(ptr, max=s - 1)[..., None].expand(
        b, e * capacity, d))
    xe = xe * valid[..., None].to(x.dtype)
    xe = xe.reshape(b, e, capacity, d)
    if spec.shard_experts:
        xe = constrain(xe, "dp", "tp", None, None)   # DP tokens × EP experts
    else:
        xe = constrain(xe, "dp", None, None, None)
    h = torch.einsum("becd,edf->becf", xe, params["wi"].to(xe.dtype))
    if cfg.act in ("swiglu", "geglu"):
        u, g = torch.chunk(h, 2, dim=-1)
        h = act_fn(cfg.act)(g) * u
    else:
        h = act_fn(cfg.act)(h)
    ye = torch.einsum("becf,efd->becd", h, params["wo"].to(h.dtype))

    # ---- combine (transposed join, in ascending slot order) ---------------
    yflat = constrain(
        ye.reshape(b, e * capacity, d) * gates[..., None].to(ye.dtype),
        "dp", None, None)
    # Slot of each (token, choice) pair: invert the sort.  A dropped pair
    # reads the appended zero row at index e·capacity.
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(s * k, device=dev).expand(b, s * k))
    pair_slot = torch.gather(slot, 1, inv).reshape(b, s, k)
    pair_slot = torch.sort(pair_slot, dim=-1).values.reshape(b, s * k)
    ypad = torch.cat([yflat, yflat.new_zeros((b, 1, d))], dim=1)
    contrib = torch.gather(ypad, 1, pair_slot[..., None].expand(
        b, s * k, d)).reshape(b, s, k, d)
    out = constrain(torch.zeros((b, s, d), dtype=ye.dtype, device=dev),
                    "dp", None, None)
    for c in range(k):
        out = out + contrib[:, :, c]
    if "shared" in params:
        out = out + mlp(params["shared"], x.reshape(b * s, d),
                        cfg.act).reshape(b, s, d)
    return out, aux
