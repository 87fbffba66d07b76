"""Plain PyTorch version of ``fused_star_gather`` (same function, no kernel)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def fused_star_gather_ref(ptrs: torch.Tensor, found: torch.Tensor,
                          tables: Sequence[torch.Tensor],
                          h: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[i] = Σⱼ tables[j][clip(ptrs[j, i])] · (found[j, i] > 0) (== h)."""
    acc = None
    for j, tbl in enumerate(tables):
        idx = ptrs[j].clamp(0, tbl.shape[0] - 1)
        rows = tbl.index_select(0, idx).to(torch.float32)
        rows = rows * (found[j] > 0)[:, None].to(torch.float32)
        acc = rows if acc is None else acc + rows
    if h is not None:
        acc = (acc == h[None, :].to(torch.float32)).to(torch.float32)
    return acc
