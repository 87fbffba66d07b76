"""Dense MLP blocks: SwiGLU (llama-family), GeGLU (gemma), plain GELU
(port of ``repro.models.mlp``)."""
from __future__ import annotations

import torch

from .. import prng
from .act_sharding import constrain
from .common import act_fn, dense_init


def init_mlp(key, d_model: int, d_ff: int, act: str, dtype):
    gated = act in ("swiglu", "geglu")
    ks = prng.split(key)
    return {
        "wi": dense_init(ks[..., 0, :],
                         (d_model, (2 if gated else 1) * d_ff), dtype),
        "wo": dense_init(ks[..., 1, :], (d_ff, d_model), dtype),
    }


def mlp(params, x, act: str) -> torch.Tensor:
    h = x @ params["wi"]
    h = constrain(h, "dp", None, "tp") if h.ndim == 3 else h
    if act in ("swiglu", "geglu"):
        u, g = torch.chunk(h, 2, dim=-1)
        h = act_fn(act)(g) * u
    else:
        h = act_fn(act)(h)
    out = h @ params["wo"]
    return constrain(out, "dp", None, None) if out.ndim == 3 else out
