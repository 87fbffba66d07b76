"""Shared building blocks: norms, RoPE, activations, init helpers (port of
``repro.models.common``, the same arithmetic in the same dtypes)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dense_init(generator: torch.Generator, shape, dtype,
               scale: float | None = None,
               device: torch.device | str | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init (LeCun), drawn from ``generator``.

    The fp32 draw is made on the generator's device and lands on
    ``device`` (default: the generator's) in ``dtype``; on ``meta`` nothing
    is drawn and the generator does not advance.
    """
    device = torch.device(device if device is not None
                          else generator.device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(s).to(device=device, dtype=dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """RMSNorm with fp32 accumulation (bf16-safe); scales by ``1 + w``."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + w.to(torch.float32))).to(x.dtype)


def layernorm(x, w, b, eps=1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * w.to(torch.float32) + b.to(torch.float32)).to(x.dtype)


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    """The activation by name; GELU is the tanh approximation, as the
    reference's ``jax.nn.gelu(approximate=True)``."""
    return {
        "swiglu": F.silu,
        "geglu": _gelu_tanh,
        "gelu": _gelu_tanh,
        "silu": F.silu,
    }[name]


# ---------------------------------------------------------------- RoPE -----
def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str | None = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Rotates by
    split halves (the first half against the second)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions[..., :, None].to(torch.float32) * freqs  # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int,
                         device: torch.device | str | None = None
                         ) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (seq, d)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10_000.0 ** (dim / d))
    out = torch.zeros((seq, d), dtype=torch.float32, device=device)
    out[:, 0::2] = torch.sin(ang)
    out[:, 1::2] = torch.cos(ang)
    return out


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return torch.tanh(logits / cap) * cap
    return logits
