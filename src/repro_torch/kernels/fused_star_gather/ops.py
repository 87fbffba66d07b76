"""Wrapper for the ``fused_star_gather`` CUDA kernel
(``csrc/fused_star_gather.cu``).

Dispatches on the device of the tensors it is given: CPU tensors take the
plain version (:func:`fused_star_gather_ref`); CUDA tensors launch the
kernel or raise.  ``fused_star_gather.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from .._build import check, load
from .ref import fused_star_gather_ref

MAX_ARMS = 8   # FSG_MAX_ARMS in the CUDA source


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_star_gather: {msg}")


def fused_star_gather(ptrs: torch.Tensor, found: torch.Tensor,
                      tables: Sequence[torch.Tensor],
                      h: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Serve-time fused star pipeline: Σⱼ Pⱼ[ptrⱼ] (== h), (n, l) float32.

    Args:
      ptrs:   (J, n) int32 FK pointers into each pre-fused partial; pointers
              outside [0, r_j) clip into range.
      found:  (J, n) bool liveness per pointer.
      tables: J float32 arrays (r_j, l) — the pre-fused partials P_j.
      h:      optional (l,) float32 compare vector (tree online phase).
    """
    if ptrs.device.type == "cpu":
        return fused_star_gather_ref(ptrs, found, tables, h)
    dev = ptrs.device
    _require(dev.type == "cuda", f"unsupported device {dev}")
    _require(ptrs.dim() == 2 and ptrs.dtype == torch.int32,
             f"ptrs must be (J, n) int32, got {tuple(ptrs.shape)} "
             f"{ptrs.dtype}")
    J, n = ptrs.shape
    _require(1 <= J <= MAX_ARMS and len(tables) == J,
             f"need 1 <= J <= {MAX_ARMS} arms with one table each, got "
             f"J={J} and {len(tables)} tables")
    _require(found.dtype == torch.bool and tuple(found.shape) == (J, n),
             f"found must be ({J}, {n}) bool, got {tuple(found.shape)} "
             f"{found.dtype}")
    l = int(tables[0].shape[1]) if tables[0].dim() == 2 else -1
    for t in tables:
        _require(t.dim() == 2 and t.shape[1] == l and t.shape[0] >= 1
                 and t.dtype == torch.float32,
                 f"tables must be (r_j >= 1, {l}) float32")
    _require(l >= 1, "tables need at least one column")
    if h is not None:
        _require(h.dtype == torch.float32 and tuple(h.shape) == (l,),
                 f"h must be ({l},) float32")
    tensors = [ptrs, found, *tables] + ([h] if h is not None else [])
    for t in tensors:
        _require(t.device == dev, "every tensor must be on one device")
        _require(t.is_contiguous(), "every tensor must be contiguous")
    out = torch.empty((n, l), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = load()
    table_ptrs = (ctypes.c_void_p * J)(*[t.data_ptr() for t in tables])
    rows = (ctypes.c_int * J)(*[int(t.shape[0]) for t in tables])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        status = lib.fused_star_gather_launch(
            ptrs.data_ptr(), found.data_ptr(), J, n, table_ptrs, rows, l,
            h.data_ptr() if h is not None else None, out.data_ptr(), stream)
    check(status, "fused_star_gather_launch")
    fused_star_gather.launches += 1
    return out


fused_star_gather.launches = 0
