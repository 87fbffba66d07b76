"""Plain PyTorch version of ``onehot_matmul``: the reference's literal
``onehot(idx) @ table`` in fp32 (same function, no kernel)."""
from __future__ import annotations

import torch

# Elements of one one-hot chunk (1 GiB of fp32): rows are taken in chunks so
# that a large n against a large r never builds the whole (n, r) matrix.
CHUNK_ELEMS = 1 << 28


def onehot_matmul_ref(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """out = onehot(idx) @ table.float(), a zero row where idx ∉ [0, r).

    A matmul, not a gather: ``0·Inf`` and ``0·NaN`` are NaN, so a
    non-finite entry of column c makes ``out[i, c]`` NaN for every row i
    whose own entry it is not.  TF32 is off (``repro_torch/__init__.py``),
    so every product is exact and the sums add one term to zeros.
    """
    (n,), (r, d) = idx.shape, table.shape
    tbl = table.to(torch.float32)
    slots = torch.arange(r, device=idx.device, dtype=idx.dtype)
    step = max(CHUNK_ELEMS // max(r, 1), 1)
    out = torch.empty((n, d), dtype=torch.float32, device=idx.device)
    for i in range(0, n, step):
        onehot = (idx[i:i + step, None] == slots[None, :]).to(torch.float32)
        out[i:i + step] = onehot @ tbl
    return out
