"""Layer blocks: (mixer → residual → MLP/MoE → residual), type-dispatched
(port of ``repro.models.blocks``).

A block's mixer is one of attn / mamba / mlstm / slstm; its MLP slot is
dense / moe / none (xLSTM blocks are self-contained).  Decode state is a
per-block NamedTuple chosen by mixer type (``KVCache``, ``MambaState``,
``MLSTMState``, ``SLSTMState``), stacked over repeats in lock-step with
the stacked block params.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from . import attention as attn
from . import mamba as mb
from . import xlstm as xl
from .common import rmsnorm
from .config import LayerSpec, ModelConfig
from .mlp import init_mlp, mlp
from .moe import init_moe, moe_mlp


def init_block(generator, cfg: ModelConfig, spec: LayerSpec, device=None):
    d = cfg.d_model
    dev = device if device is not None else generator.device
    params: dict = {"norm1": torch.zeros((d,), dtype=cfg.pdtype, device=dev)}
    if spec.mixer == "attn":
        params["attn"] = attn.init_attention(generator, cfg, device=device)
    elif spec.mixer == "mamba":
        params["mamba"] = mb.init_mamba(generator, cfg, device=device)
    elif spec.mixer == "mlstm":
        params["mlstm"] = xl.init_mlstm(generator, cfg, device=device)
    elif spec.mixer == "slstm":
        params["slstm"] = xl.init_slstm(generator, cfg, device=device)
    else:
        raise ValueError(spec.mixer)
    if spec.mlp == "dense":
        params["norm2"] = torch.zeros((d,), dtype=cfg.pdtype, device=dev)
        params["mlp"] = init_mlp(generator, d, cfg.d_ff, cfg.act,
                                 cfg.pdtype, device=device)
    elif spec.mlp == "moe":
        params["norm2"] = torch.zeros((d,), dtype=cfg.pdtype, device=dev)
        params["moe"] = init_moe(generator, cfg, device=device)
    return params


def block_forward(params, x, cfg: ModelConfig, spec: LayerSpec, positions,
                  causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence pass. Returns (x, moe_aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(x, params["norm1"], cfg.norm_eps)
    if spec.mixer == "attn":
        mixed = attn.attention_train(params["attn"], h, cfg, positions,
                                     causal=causal)
    elif spec.mixer == "mamba":
        mixed = mb.mamba_forward(params["mamba"], h, cfg)
    elif spec.mixer == "mlstm":
        mixed = xl.mlstm_forward(params["mlstm"], h, cfg)
    else:
        mixed = xl.slstm_forward(params["slstm"], h, cfg)
    x = x + mixed
    if spec.mlp == "dense":
        h = rmsnorm(x, params["norm2"], cfg.norm_eps)
        x = x + mlp(params["mlp"], h, cfg.act)
    elif spec.mlp == "moe":
        h = rmsnorm(x, params["norm2"], cfg.norm_eps)
        y, aux = moe_mlp(params["moe"], h, cfg)
        x = x + y
    return x, aux


def init_block_state(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, device=None) -> Any:
    if spec.mixer == "attn":
        return attn.init_kv_cache(batch, max_len, cfg, cfg.cdtype,
                                  device=device)
    if spec.mixer == "mamba":
        return mb.init_mamba_state(batch, cfg, cfg.cdtype, device=device)
    if spec.mixer == "mlstm":
        return xl.init_mlstm_state(batch, cfg, device=device)
    return xl.init_slstm_state(batch, cfg, device=device)


def block_decode(params, x, state, cfg: ModelConfig, spec: LayerSpec
                 ) -> Tuple[torch.Tensor, Any]:
    """Single-token pass. x: (B, 1, D).  An attention block writes its KV
    cache in place; a recurrent block returns its new state as fresh
    tensors."""
    h = rmsnorm(x, params["norm1"], cfg.norm_eps)
    if spec.mixer == "attn":
        mixed, state = attn.attention_decode(params["attn"], h, cfg, state)
    elif spec.mixer == "mamba":
        mixed, state = mb.mamba_decode_step(params["mamba"], h, state, cfg)
    elif spec.mixer == "mlstm":
        mixed, state = xl.mlstm_decode_step(params["mlstm"], h, state, cfg)
    else:
        mixed, state = xl.slstm_decode_step(params["slstm"], h, state, cfg)
    x = x + mixed
    if spec.mlp == "dense":
        h = rmsnorm(x, params["norm2"], cfg.norm_eps)
        x = x + mlp(params["mlp"], h, cfg.act)
    elif spec.mlp == "moe":
        h = rmsnorm(x, params["norm2"], cfg.norm_eps)
        y, _ = moe_mlp(params["moe"], h, cfg)
        x = x + y
    return x, state
