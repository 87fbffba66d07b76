"""Gradient compression for the data-parallel all-reduce (port of
``repro.optim.compression``).

int8 block-quantization with error feedback: each worker quantizes its
local gradient to int8 blocks of ``BLOCK`` values with an fp32 per-block
scale (4× fewer bytes on the wire than fp32), and the quantization
residual is carried to the next step (error feedback keeps SGD/Adam
convergence — Karimireddy et al., arXiv:1901.09847).  ``torch.round``
rounds half to even, as ``jnp.round`` does, so both packages give the
same payload.

Usage in a train step (accumulated grads g, residual r):
    q, r_new = compress(g + r)
    g_hat = decompress(q)                 # what the all-reduce carries
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..tree import leaves, tree_map, unflatten

BLOCK = 256


class Compressed(NamedTuple):
    q: torch.Tensor       # (n_blocks, BLOCK) int8 payload (padded)
    scale: torch.Tensor   # (n_blocks,) fp32 per-block scale
    shape: tuple
    dtype: torch.dtype


def compress(x: torch.Tensor) -> Tuple[Compressed, torch.Tensor]:
    """Quantize to int8 blocks. Returns (payload, residual)."""
    xf = x.to(torch.float32)
    flat = xf.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    blocks = F.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1) / 127.0       # (nb,)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127
                    ).to(torch.int8)
    deq = (q.to(torch.float32) * scale[:, None]).reshape(-1)
    residual = (flat - deq[:flat.shape[0]]).reshape(x.shape).to(x.dtype)
    return Compressed(q, scale, tuple(x.shape), x.dtype), residual


def decompress(c: Compressed) -> torch.Tensor:
    flat = (c.q.to(torch.float32) * c.scale[:, None]).reshape(-1)
    n = 1
    for s in c.shape:
        n *= s
    return flat[:n].reshape(c.shape).to(c.dtype)


def compress_tree(grads, residuals):
    """Apply error-feedback compression across a gradient tree; returns
    (decompressed grads, new residuals)."""
    if residuals is None:
        residuals = tree_map(torch.zeros_like, grads)
    fed = tree_map(lambda g, r: g + r.to(g.dtype), grads, residuals)
    pairs = [compress(g) for g in leaves(fed)]
    return (unflatten(grads, [decompress(c) for c, _ in pairs]),
            unflatten(grads, [r for _, r in pairs]))
