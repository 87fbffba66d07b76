"""Common key-domain construction (port of ``repro.core.laq.domain``).

Only what the dense one-hot join needs: ``key_domain`` and ``positions``.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .table import PAD_KEY


def key_domain(keys: Sequence[torch.Tensor], size: int) -> torch.Tensor:
    """Sorted union of key arrays, padded (or cut) to ``size`` with PAD_KEY.

    ``jnp.unique(size=, fill_value=)`` has no torch counterpart: unique,
    then pad.
    """
    allk = torch.cat([k.reshape(-1) for k in keys])
    u = torch.unique(allk, sorted=True)[:size]
    dom = torch.full((size,), PAD_KEY, dtype=allk.dtype, device=allk.device)
    dom[:u.shape[0]] = u
    return dom


def positions(domain: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Map keys to their slots in the sorted domain (vectorized binary search).

    Returns int32 positions; keys absent from the domain and PAD_KEY map to
    ``len(domain)`` (an out-of-range slot).
    """
    n = domain.shape[0]
    pos = torch.searchsorted(domain, keys, out_int32=True)
    hit = domain[pos.clamp(0, n - 1)] == keys
    pad = keys == PAD_KEY
    return torch.where(hit & ~pad, pos, torch.full_like(pos, n))
