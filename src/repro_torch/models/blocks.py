"""Layer blocks: (mixer → residual → MLP → residual), type-dispatched (port
of ``repro.models.blocks``).

A block's mixer is one of attn / mamba / mlstm / slstm; its MLP slot is
dense / moe / none.  The port has the ``attn`` mixer and the ``dense`` and
``none`` MLP slots; the Mamba, mLSTM and sLSTM mixers and the MoE slot
raise ``NotImplementedError`` until their slice of the port lands.  Decode
state is a per-block NamedTuple chosen by mixer type, stacked over repeats
in lock-step with the stacked block params.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from . import attention as attn
from .common import rmsnorm
from .config import LayerSpec, ModelConfig
from .mlp import init_mlp, mlp

_NOT_PORTED = ("mamba", "mlstm", "slstm", "moe")


def check_spec(spec: LayerSpec) -> None:
    """Raise ``NotImplementedError`` for a layer the port cannot run yet
    (and ``ValueError`` for an unknown mixer, as the reference does)."""
    for part in (spec.mixer, spec.mlp):
        if part in _NOT_PORTED:
            raise NotImplementedError(
                f"the {part!r} layer is not ported yet: the Mamba, "
                "mLSTM/sLSTM and MoE modules come in slice 7c of the port")
    if spec.mixer != "attn":
        raise ValueError(spec.mixer)


def init_block(generator, cfg: ModelConfig, spec: LayerSpec, device=None):
    check_spec(spec)
    d = cfg.d_model
    dev = device if device is not None else generator.device
    params: dict = {"norm1": torch.zeros((d,), dtype=cfg.pdtype, device=dev),
                    "attn": attn.init_attention(generator, cfg,
                                                device=device)}
    if spec.mlp == "dense":
        params["norm2"] = torch.zeros((d,), dtype=cfg.pdtype, device=dev)
        params["mlp"] = init_mlp(generator, d, cfg.d_ff, cfg.act,
                                 cfg.pdtype, device=device)
    return params


def block_forward(params, x, cfg: ModelConfig, spec: LayerSpec, positions,
                  causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence pass. Returns (x, moe_aux_loss)."""
    check_spec(spec)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(x, params["norm1"], cfg.norm_eps)
    x = x + attn.attention_train(params["attn"], h, cfg, positions,
                                 causal=causal)
    if spec.mlp == "dense":
        h = rmsnorm(x, params["norm2"], cfg.norm_eps)
        x = x + mlp(params["mlp"], h, cfg.act)
    return x, aux


def init_block_state(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, device=None) -> Any:
    check_spec(spec)
    return attn.init_kv_cache(batch, max_len, cfg, cfg.cdtype, device=device)


def block_decode(params, x, state, cfg: ModelConfig, spec: LayerSpec
                 ) -> Tuple[torch.Tensor, Any]:
    """Single-token pass. x: (B, 1, D)."""
    check_spec(spec)
    h = rmsnorm(x, params["norm1"], cfg.norm_eps)
    mixed, state = attn.attention_decode(params["attn"], h, cfg, state)
    x = x + mixed
    if spec.mlp == "dense":
        h = rmsnorm(x, params["norm2"], cfg.norm_eps)
        x = x + mlp(params["mlp"], h, cfg.act)
    return x, state
