"""Wrapper for the ``tree_predict`` CUDA kernel (``csrc/tree_predict.cu``).

Dispatches on the device of the tensors it is given: CPU tensors take the
plain version (:func:`tree_predict_ref`); CUDA tensors launch the kernel or
raise.  ``tree_predict.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from .._build import check, load
from .ref import tree_predict_ref

# The largest dynamic shared memory one block may take on Hopper.
MAX_SMEM_BYTES = 232_448


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"tree_predict: {msg}")


def tree_predict(x: torch.Tensor, f: torch.Tensor, v: torch.Tensor,
                 h: torch.Tensor, hsum: torch.Tensor) -> torch.Tensor:
    """Fused ((x·F > v)·H) == hsum — one-hot leaf encoding (n, l) float32.

    x (n, k); f (k, p) one-hot feature selector; v (p,) thresholds;
    h (p, l) ±1 path matrix; hsum (l,) per-leaf true-side counts.

    On a card the result equals :func:`tree_predict_ref` bit for bit, by
    two paths the kernel picks on the card (the host never waits for it):

    * predicates: a column of ``f`` that is exactly one-hot (one entry 1,
      the rest 0) is a gather of ``x[:, feat]``, false wherever the row holds
      a NaN or ±Inf at another feature (the reference's ``0·NaN`` terms);
      any other column is an fp32 dot over k (fmaf in feature order);
    * scores: when every entry of ``h`` is −1, 0 or 1 they run on tensor
      cores (bf16 operands, fp32 sums: exact); an ``h`` with any other entry
      (NaN, ±Inf, 0.5, ...) takes the fp32 score branch.

    ``tree_predict.last_flags`` holds the last CUDA launch's int32 pair on
    the card, a tensor of its own (the scratch is freed after the call):
    ``[1 if the fp32 score branch ran else 0, columns of f that are not
    one-hot]``.
    """
    if x.device.type == "cpu":
        return tree_predict_ref(x, f, v, h, hsum)
    dev = x.device
    _require(dev.type == "cuda", f"unsupported device {dev}")
    _require(x.dim() == 2 and f.dim() == 2 and h.dim() == 2,
             "x, f and h must be 2-D")
    n, k = x.shape
    p, l = h.shape
    _require(tuple(f.shape) == (k, p),
             f"f must be ({k}, {p}), got {tuple(f.shape)}")
    _require(tuple(v.shape) == (p,), f"v must be ({p},)")
    _require(tuple(hsum.shape) == (l,), f"hsum must be ({l},)")
    _require(l >= 1, "need at least one leaf")
    for t in (x, f, v, h, hsum):
        _require(t.dtype == torch.float32, "every tensor must be float32")
        _require(t.device == dev, "every tensor must be on one device")
        _require(t.is_contiguous(), "every tensor must be contiguous")
    out = torch.empty((n, l), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = load()
    smem = lib.tree_predict_smem_bytes(k, p, l)
    _require(0 <= smem <= MAX_SMEM_BYTES,
             f"k={k}, p={p}, l={l}: no row tile fits the "
             f"{MAX_SMEM_BYTES} bytes of shared memory one block may take")
    scratch = torch.empty(lib.tree_predict_scratch_bytes(p, l),
                          dtype=torch.uint8, device=dev)
    flags = torch.empty(2, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        status = lib.tree_predict_launch(
            x.data_ptr(), f.data_ptr(), v.data_ptr(), h.data_ptr(),
            hsum.data_ptr(), out.data_ptr(), n, k, p, l, scratch.data_ptr(),
            flags.data_ptr(), stream)
    check(status, "tree_predict_launch")
    tree_predict.launches += 1
    tree_predict.last_flags = flags
    return out


tree_predict.launches = 0
tree_predict.last_flags = None
