"""Wrapper for the ``onehot_matmul`` CUDA kernel (``csrc/onehot_matmul.cu``).

Dispatches on the device of the tensors it is given: CPU tensors take the
plain version (:func:`onehot_matmul_ref`); CUDA tensors launch the kernel or
raise.  ``onehot_matmul.launches`` counts kernel launches.  No query path
calls it, in the reference or here: it is a public op of the kernels
package.
"""
from __future__ import annotations

import torch

from .._build import check, load
from .ref import onehot_matmul_ref

TABLE_DTYPES = (torch.float32, torch.bfloat16)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"onehot_matmul: {msg}")


def onehot_matmul(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``onehot(idx) @ table`` as (n, d) float32: row ``table[idx[i]]``, a
    zero row where idx is outside [0, r), and NaN wherever the matmul's
    ``0·Inf``/``0·NaN`` makes one (see :func:`onehot_matmul_ref`).

    idx (n,) int32; table (r, d) float32 or bfloat16.
    """
    if idx.device.type == "cpu":
        return onehot_matmul_ref(idx, table)
    dev = idx.device
    _require(dev.type == "cuda", f"unsupported device {dev}")
    _require(idx.dim() == 1 and idx.dtype == torch.int32,
             f"idx must be (n,) int32, got {tuple(idx.shape)} {idx.dtype}")
    _require(table.dim() == 2 and table.dtype in TABLE_DTYPES,
             f"table must be (r, d) float32 or bfloat16, got "
             f"{tuple(table.shape)} {table.dtype}")
    _require(table.device == dev, "idx and table must be on one device")
    _require(idx.is_contiguous() and table.is_contiguous(),
             "idx and table must be contiguous")
    n = idx.shape[0]
    r, d = table.shape
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    if n == 0 or d == 0:
        return out
    nonfinite = torch.empty((d,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        status = load().onehot_matmul_launch(
            idx.data_ptr(), n, table.data_ptr(), r, d,
            int(table.dtype == torch.bfloat16), nonfinite.data_ptr(),
            out.data_ptr(), stream)
    check(status, "onehot_matmul_launch")
    onehot_matmul.launches += 1
    return out


onehot_matmul.launches = 0
