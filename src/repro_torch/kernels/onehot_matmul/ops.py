"""Wrapper for the ``onehot_matmul`` CUDA kernel (``csrc/onehot_matmul.cu``).

Dispatches on the device of the tensors it is given: CPU tensors take the
plain version (:func:`onehot_matmul_ref`); CUDA tensors launch the kernel or
raise.  ``onehot_matmul.launches`` counts kernel launches.  No query path
calls it, in the reference or here: it is a public op of the kernels
package.

The launch geometry is computed here (:func:`launch_geometry`) and passed
to the CUDA entry point, which checks it; the CPU tests hold it to the
kernel's loops.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .._build import check, load
from .ref import onehot_matmul_ref

TABLE_DTYPES = (torch.float32, torch.bfloat16)

THREADS = 256             # OHM_THREADS
MAX_SLABS = 256           # OHM_MAX_SLABS: one slab flag per gather thread
NF_COLS = 512             # OHM_NF_COLS: a tile of per-column counts
SLAB_MIN_ENTRIES = 4096   # entries below which a slab is not split further
ROWS_PER_STEP = 2         # rows a one-lane row gathers at once (1 or 2)
OFFSET_LIMIT = 1 << 31    # n·d or r·d from here on take 64-bit offsets
MAX_BLOCKS = (1 << 31) - 1


class Geometry(ctypes.Structure):
    """One launch's shape; ``onehot_matmul_launch`` reads it by reference
    (``OhmGeometry`` in the CUDA source)."""
    _fields_ = [
        ("slabs", ctypes.c_int),            # count blocks, one row slab each
        ("slab_rows", ctypes.c_int),        # rows of a slab (last: fewer)
        ("count_lanes_log", ctypes.c_int),  # flagged slab: lanes on columns
        ("gather_vec", ctypes.c_int),       # entries a gather: 4, or 1
        ("row_lanes_log", ctypes.c_int),    # lanes that own one output row
        ("rows_per_step", ctypes.c_int),    # rows a lane gathers at once
        ("gather_blocks", ctypes.c_int),    # about one pass over the rows
        ("wide", ctypes.c_int),             # 64-bit offsets
    ]


def _log2_ceil(x: int) -> int:
    return (x - 1).bit_length() if x > 1 else 0


@functools.lru_cache(maxsize=1024)
def launch_geometry(n: int, r: int, d: int,
                    table_aligned: bool) -> Geometry:
    """The launch of ``onehot(idx) @ table`` for idx (n,), table (r, d).

    ``table_aligned``: the table's address is a multiple of 4 entries'
    bytes (16 for fp32, 8 for bf16), so d % 4 == 0 rows gather 4 entries
    per load.  The gather grid covers the rows about once, so the card's
    block scheduler balances them over its SMs; it rounds down, so a row
    index one step past the last row stays below 2**32.
    Cached: the result is shared, not to be changed.
    """
    slabs = min(MAX_SLABS, r, -(-(r * d) // SLAB_MIN_ENTRIES)) if r else 0
    slab_rows = -(-r // slabs) if slabs else 0
    slabs = -(-r // slab_rows) if slabs else 0
    gather_vec = 4 if d % 4 == 0 and table_aligned else 1
    row_lanes_log = min(5, _log2_ceil(d // gather_vec))
    rows_per_step = ROWS_PER_STEP if row_lanes_log == 0 else 1
    rows_per_pass = (THREADS >> row_lanes_log) * rows_per_step
    return Geometry(
        slabs=slabs, slab_rows=slab_rows,
        count_lanes_log=min(8, _log2_ceil(min(d, NF_COLS))),
        gather_vec=gather_vec, row_lanes_log=row_lanes_log,
        rows_per_step=rows_per_step,
        gather_blocks=max(1, min(n // rows_per_pass, MAX_BLOCKS)),
        wide=int(n * d >= OFFSET_LIMIT or r * d >= OFFSET_LIMIT))


def _reject(idx: torch.Tensor, table: torch.Tensor) -> None:
    dev = idx.device
    for ok, msg in (
            (dev.type == "cuda", f"unsupported device {dev}"),
            (idx.dim() == 1 and idx.dtype == torch.int32,
             f"idx must be (n,) int32, got {tuple(idx.shape)} {idx.dtype}"),
            (table.dim() == 2 and table.dtype in TABLE_DTYPES,
             f"table must be (r, d) float32 or bfloat16, got "
             f"{tuple(table.shape)} {table.dtype}"),
            (table.device == dev, "idx and table must be on one device"),
            (idx.is_contiguous() and table.is_contiguous(),
             "idx and table must be contiguous")):
        if not ok:
            raise ValueError(f"onehot_matmul: {msg}")


def onehot_matmul(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``onehot(idx) @ table`` as (n, d) float32: row ``table[idx[i]]``, a
    zero row where idx is outside [0, r), and NaN wherever the matmul's
    ``0·Inf``/``0·NaN`` makes one (see :func:`onehot_matmul_ref`).

    idx (n,) int32; table (r, d) float32 or bfloat16.

    ``onehot_matmul.last_launch`` holds the last CUDA launch's
    ``(Geometry, scratch)``; the scratch's first ``slabs`` int32 are the
    slab flags, any of them set when the gather took the NaN rule's path.
    """
    if idx.device.type == "cpu":
        return onehot_matmul_ref(idx, table)
    dev = idx.device
    if not (dev.type == "cuda" and idx.dim() == 1
            and idx.dtype == torch.int32 and table.dim() == 2
            and table.dtype in TABLE_DTYPES and table.device == dev
            and idx.is_contiguous() and table.is_contiguous()):
        _reject(idx, table)
    n = idx.shape[0]
    r, d = table.shape
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    if n == 0 or d == 0:
        return out
    bf16 = table.dtype == torch.bfloat16
    index = dev.index
    geom = launch_geometry(n, r, d,
                           table.data_ptr() % (8 if bf16 else 16) == 0)
    scratch = torch.empty(geom.slabs * (d + 1), dtype=torch.int32,
                          device=dev)
    args = (idx.data_ptr(), n, table.data_ptr(), r, d, bf16,
            scratch.data_ptr(), out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(index), ctypes.byref(geom))
    if index == torch._C._cuda_getDevice():
        status = load().onehot_matmul_launch(*args)
    else:
        with torch.cuda.device(dev):
            status = load().onehot_matmul_launch(*args)
    check(status, "onehot_matmul_launch")
    onehot_matmul.launches += 1
    onehot_matmul.last_launch = (geom, scratch)
    return out


onehot_matmul.launches = 0
onehot_matmul.last_launch = None
