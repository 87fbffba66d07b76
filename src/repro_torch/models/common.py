"""Shared building blocks: norms, RoPE, activations, init helpers (port of
``repro.models.common``, the same arithmetic in the same dtypes)."""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import prng
from ..tree import tree_map
from .act_sharding import lift


class Dense:
    """A truncated-normal leaf, described and not drawn: ``shape`` under
    each of the keys ``key`` (``(*batch, 2)``; a batch of keys gives a
    stack of draws, as ``jax.vmap`` over keys), times the fp32 ``scale``,
    in ``dtype``.  ``draw`` makes the whole leaf or any box of it."""

    def __init__(self, key: torch.Tensor, shape, dtype: torch.dtype,
                 scale: float):
        self.key, self.leaf_shape = key, tuple(shape)
        self.dtype, self.scale = dtype, scale

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.key.shape[:-1]) + self.leaf_shape

    def draw(self, device, block: Optional[prng.Block] = None
             ) -> torch.Tensor:
        def scaled(bits):
            return prng.truncated_normal_from_bits(bits, -2.0, 2.0).mul_(
                self.scale).to(self.dtype)

        return prng.draw(self.key, self.leaf_shape, self.dtype, scaled,
                         block=block, device=device)


class Fixed:
    """A leaf that no key decides (zeros, ones, Mamba's ``A_log``):
    ``fill(offset, shape, device)`` computes any box of it directly, so a
    box is never cut from the whole leaf."""

    def __init__(self, shape, dtype: torch.dtype,
                 fill: Callable[..., torch.Tensor]):
        self.shape, self.dtype, self.fill = tuple(shape), dtype, fill

    def draw(self, device, block: Optional[prng.Block] = None
             ) -> torch.Tensor:
        offset, box = block if block is not None else (
            (0,) * len(self.shape), self.shape)
        return self.fill(tuple(offset), tuple(box), torch.device(device)
                         ).to(self.dtype)


def dense_init(key: torch.Tensor, shape, dtype,
               scale: float | None = None) -> Dense:
    """Truncated-normal fan-in init (LeCun) under ``key``, described: the
    reference's ``jax.random.truncated_normal(key, -2, 2, shape) * s``
    with ``s`` an fp32 ``1/sqrt(fan_in)`` or the given scale rounded to
    fp32, cast to ``dtype``."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    s = (np.float32(1.0) / np.sqrt(np.float32(fan_in)) if scale is None
         else np.float32(scale))
    return Dense(key, shape, dtype, float(s))


def const_init(key: torch.Tensor, shape, dtype, value: float) -> Fixed:
    """A leaf of ``shape`` filled with ``value``, stacked over ``key``'s
    batch dims as a draw under those keys would be."""
    return Fixed(tuple(key.shape[:-1]) + tuple(shape), dtype,
                 lambda offset, box, device: torch.full(
                     box, value, dtype=dtype, device=device))


def draw_tree(tree, device) -> Any:
    """Every described leaf of ``tree`` drawn whole on ``device`` (on
    ``meta``: shapes and dtypes, nothing drawn)."""
    return tree_map(lambda leaf: leaf.draw(device), tree)


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
    freqs = lift(rope_freqs(hd, theta, x.device), x)        # (hd/2,)
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
