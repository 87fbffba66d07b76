"""Carry tables and models across as plain numpy arrays.

A caller that holds objects of another implementation takes their arrays
out as numpy (``np.asarray(...)``) and builds the port's objects here, so
both implementations compute on the same data.  This module imports only
numpy and torch.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .core.fusion.operators import DecisionTreeGEMM, LinearOperator
from .core.laq.table import Table
from .device import DeviceLike, resolve_device


def table_from_arrays(name: str, columns: Sequence[str], matrix: np.ndarray,
                      keys: Mapping[str, np.ndarray], nvalid: int,
                      device: DeviceLike = None) -> Table:
    """A port ``Table`` holding exactly these arrays (float32 / int32)."""
    dev = resolve_device(device)
    mat = np.asarray(matrix, np.float32)
    if mat.ndim != 2 or mat.shape[1] != len(columns):
        raise ValueError(f"matrix {mat.shape} does not match "
                         f"{len(columns)} columns")
    key_t = {}
    for c, k in keys.items():
        k = np.asarray(k)
        if k.shape != (mat.shape[0],):
            raise ValueError(f"key column {c!r} has shape {k.shape}, "
                             f"expected ({mat.shape[0]},)")
        key_t[c] = torch.from_numpy(k.astype(np.int32)).to(dev)
    return Table(name, tuple(columns), torch.from_numpy(mat.copy()).to(dev),
                 key_t, int(nvalid))


def model_from_arrays(kind: str, **arrays):
    """A port model from its arrays, kept on the host.

    ``kind="linear"`` takes ``L`` and optionally ``bias``; ``kind="tree"``
    takes ``F``, ``v``, ``H`` and ``h``.  ``compile_query`` moves the model
    to its tables' device.
    """
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32).copy())

    if kind == "linear":
        bias = arrays.get("bias")
        return LinearOperator(t(arrays["L"]),
                              None if bias is None else t(bias))
    if kind == "tree":
        return DecisionTreeGEMM(t(arrays["F"]), t(arrays["v"]),
                                t(arrays["H"]), t(arrays["h"]))
    raise ValueError(f"model kind {kind!r} not one of ('linear', 'tree')")
