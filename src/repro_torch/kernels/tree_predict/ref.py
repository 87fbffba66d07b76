"""Plain PyTorch version of ``tree_predict``: ``DecisionTreeGEMM.apply`` on
tensors."""
from __future__ import annotations

import torch


def tree_predict_ref(x: torch.Tensor, f: torch.Tensor, v: torch.Tensor,
                     h: torch.Tensor, hsum: torch.Tensor) -> torch.Tensor:
    feats = x.to(torch.float32) @ f.to(torch.float32)
    preds = (feats > v.reshape(1, -1)).to(torch.float32)
    score = preds @ h.to(torch.float32)
    return (score == hsum.reshape(1, -1)).to(torch.float32)
