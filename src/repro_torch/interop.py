"""Carry tables, catalogs, models and LM weights across as plain numpy
arrays.

A caller that holds objects of another implementation takes their arrays
out as numpy (``np.asarray(...)``) and builds the port's objects here, so
both implementations compute on the same data: a table with its tombstone
mask, a catalog with its tables' versions, an LM's parameter tree.  This
module imports only numpy and torch.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from .core.fusion.operators import DecisionTreeGEMM, LinearOperator
from .core.laq.catalog import Catalog
from .core.laq.table import Table
from .device import DeviceLike, resolve_device
from .models import LM, ModelConfig


def table_from_arrays(name: str, columns: Sequence[str], matrix: np.ndarray,
                      keys: Mapping[str, np.ndarray], nvalid: int,
                      device: DeviceLike = None,
                      deleted: Optional[np.ndarray] = None) -> Table:
    """A port ``Table`` holding exactly these arrays (float32 / int32, and
    the bool tombstone mask ``deleted`` when the table has one)."""
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
    dead = None
    if deleted is not None:
        dead = np.asarray(deleted, bool)
        if dead.shape != (mat.shape[0],):
            raise ValueError(f"tombstone mask has shape {dead.shape}, "
                             f"expected ({mat.shape[0]},)")
        dead = torch.from_numpy(dead.copy()).to(dev)
    return Table(name, tuple(columns), torch.from_numpy(mat.copy()).to(dev),
                 key_t, int(nvalid), dead)


def catalog_from_tables(tables: Mapping[str, Table],
                        versions: Optional[Mapping[str, int]] = None, *,
                        read_only: bool = False) -> Catalog:
    """A port ``Catalog`` over ``tables`` whose tables stand at
    ``versions`` (0 where absent).

    The catalog keeps no delta history from before those versions: an
    artifact that asks for older history gets ``CatalogHistoryError`` and
    rebuilds, as it would from a catalog whose log was compacted.
    """
    cat = Catalog(tables, read_only=read_only)
    for name, v in (versions or {}).items():
        if name not in cat:
            raise KeyError(f"version given for unknown table {name!r}")
        cat._versions[name] = int(v)
        cat._floor[name] = int(v)
    return cat


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


def lm_params_from_arrays(cfg: ModelConfig, tree: Mapping[str, Any],
                          device: DeviceLike = None) -> dict:
    """The port's LM parameters holding ``tree``'s arrays, each leaf in the
    dtype the port's own ``LM(cfg).init`` gives it: ``cfg.pdtype``, save
    the leaves both packages keep in fp32 whatever the config's dtype (the
    MoE ``router``, Mamba's ``A_log`` and ``D``).

    ``tree`` is the reference's parameter tree (nested mappings of arrays,
    stacked over repeats where the reference stacks them), its leaves
    anything ``np.asarray`` takes (a bfloat16 leaf goes through float32,
    which holds it exactly).  Keys and shapes are checked against the tree
    the port's own ``LM(cfg).init`` makes; any difference raises
    ``ValueError``.
    """
    dev = resolve_device(device)
    want = LM(cfg).init(torch.Generator(), device="meta")

    def convert(want_node, node, path):
        if isinstance(want_node, dict):
            if not isinstance(node, Mapping):
                raise ValueError(f"{path or 'params'}: expected a mapping, "
                                 f"got {type(node).__name__}")
            if set(node) != set(want_node):
                raise ValueError(
                    f"{path or 'params'}: keys {sorted(node)} differ from "
                    f"the port's {sorted(want_node)}")
            return {k: convert(want_node[k], node[k], f"{path}/{k}")
                    for k in want_node}
        arr = np.asarray(node)
        if tuple(arr.shape) != tuple(want_node.shape):
            raise ValueError(f"{path}: shape {tuple(arr.shape)} differs from "
                             f"the port's {tuple(want_node.shape)}")
        return torch.from_numpy(np.array(arr, np.float32)).to(
            device=dev, dtype=want_node.dtype)

    return convert(want, tree, "")
