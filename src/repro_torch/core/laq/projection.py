"""Projection as matrix multiplication (port of ``repro.core.laq.projection``).

``π_{cols}(S) = S · M`` with the column-mapping matrix ``M ∈ {0,1}^{c×k}``.
"""
from __future__ import annotations

from typing import Sequence

import torch


def mapping_matrix(source_cols: Sequence[str], target_cols: Sequence[str],
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """Build M ∈ {0,1}^{c×k} mapping source columns to target columns."""
    m = torch.zeros((len(source_cols), len(target_cols)), dtype=dtype,
                    device=device)
    src = list(source_cols)
    for j, name in enumerate(target_cols):
        m[src.index(name), j] = 1
    return m
