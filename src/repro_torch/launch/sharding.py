"""Sharding rules over a mesh: ``PartitionSpec``, the divisibility
fallback, and the parameter, batch and cache specs of the LM (port of
``repro.launch.sharding``).

A spec names, per tensor dimension, the mesh axis (or tuple of axes) it
is split over, ``None`` for a dimension every position holds whole.  A
dimension that does not divide its axes is left whole instead of failing
(``safe_spec``): the reference's 15-heads-on-16-way rule, which the
placement planner applies to prefused partials' row counts.

The LM's 2-D logical layout over the physical mesh (pod, data, model):

* **TP** ("model"): attention heads / FFN hidden / vocab / experts.
* **FSDP** ("data"): the other major dim of every weight (ZeRO-3 — params,
  grads and AdamW moments all shard this way).
* **DP** ("pod"+"data"): batch dim of activations; "pod" is pure DP across
  the slower inter-pod links.

The LM's rules read only a mesh's axis names and sizes, of a ``Mesh`` or
a ``DeviceMesh`` (``mesh.axis_sizes``).  ``param_shardings`` returns a
tree of ``PartitionSpec``s (the port has no ``NamedSharding``);
``placements`` turns a spec into DTensor placements on a ``DeviceMesh``
and ``distribute_tree`` places a tree of tensors by a tree of specs, as
the sharded LM (``models/act_sharding.py``), the dry run's shaped inputs
(``steps.py``) and the training driver do; ``from_local`` builds a
DTensor from each rank's own shard (the global batch, a restored
checkpoint).
"""
from __future__ import annotations

from typing import Any, List

import torch
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from ..tree import flatten_with_paths, unflatten
from .mesh import axis_names, axis_sizes, dp_axes


class PartitionSpec(tuple):
    """Per-dimension mesh axes of a placed tensor (``None``: whole).

    A tuple, so it compares equal to jax's ``PartitionSpec`` of the same
    entries and to a plain tuple.
    """

    def __new__(cls, *partitions):
        return super().__new__(cls, partitions)


P = PartitionSpec


def _div(mesh, dim: int, axis) -> bool:
    if axis is None:
        return True
    axes = (axis,) if isinstance(axis, str) else axis
    sizes = axis_sizes(mesh)
    total = 1
    for a in axes:
        if a not in sizes:
            return False
        total *= sizes[a]
    return dim % total == 0


def safe_spec(mesh, shape, *axes) -> PartitionSpec:
    """PartitionSpec with the divisibility fallback per dimension."""
    return P(*[a if _div(mesh, d, a) else None
               for d, a in zip(shape, axes)])


_spec = safe_spec


FSDP = ("pod", "data")  # pod folds into the FSDP axis when present


def param_pspec(path: str, shape, mesh, cfg) -> PartitionSpec:
    """PartitionSpec for one parameter leaf (path is '/'-joined)."""
    parts = path.split("/")
    leaf = parts[-1]
    stacked = parts[0] in ("blocks", "encoder", "cross")
    body = shape[1:] if stacked else shape

    def out(*axes):
        spec = _spec(mesh, body, *axes)
        return P(None, *spec) if stacked else spec

    # ---- embeddings / head -------------------------------------------------
    if leaf == "embed":
        return _spec(mesh, shape, "model", ("pod", "data"))
    if leaf == "lm_head":
        return _spec(mesh, shape, ("pod", "data"), "model")
    if leaf in ("final_norm", "enc_norm"):
        return P(None)
    # ---- norms / small vectors ---------------------------------------------
    if leaf.startswith("norm") or leaf in ("xnorm", "b", "dt_bias", "conv_b"):
        return out(*([None] * len(body)))
    # ---- attention ----------------------------------------------------------
    if len(parts) >= 2 and parts[-2] in ("attn", "xattn"):
        if leaf in ("wq", "wk", "wv"):
            return out(FSDP, "model")
        if leaf == "wo":
            return out("model", FSDP)
    # ---- dense mlp / shared expert ------------------------------------------
    if leaf == "wi" and len(body) == 2:
        return out(FSDP, "model")
    if leaf == "wo" and len(body) == 2:
        return out("model", FSDP)
    # ---- MoE ----------------------------------------------------------------
    if leaf == "router":
        return out(FSDP, None)
    if leaf == "wi" and len(body) == 3:   # (E, D, F)
        if cfg.moe is not None and cfg.moe.shard_experts and _div(
                mesh, body[0], "model"):
            return out("model", FSDP, None)
        return out(None, FSDP, "model")
    if leaf == "wo" and len(body) == 3:   # (E, F, D)
        if cfg.moe is not None and cfg.moe.shard_experts and _div(
                mesh, body[0], "model"):
            return out("model", None, FSDP)
        return out(None, "model", FSDP)
    # ---- mamba --------------------------------------------------------------
    if leaf == "in_proj":
        return out(FSDP, "model")
    if leaf == "conv_w":
        return out(None, "model")
    if leaf == "x_proj":
        return out("model", None)
    if leaf == "dt_proj":
        return out(None, "model")
    if leaf == "A_log":
        return out("model", None)
    if leaf == "D":
        return out("model")
    if leaf == "out_proj":
        return out("model", FSDP)
    # ---- xLSTM --------------------------------------------------------------
    if leaf == "up":
        return out(FSDP, "model")
    if leaf in ("wq", "wk", "wv") and len(body) == 2:   # mlstm projections
        return out("model", None)
    if leaf == "wif":
        return out("model", None)
    if leaf == "down":
        return out("model", FSDP)
    if leaf == "w":                                      # slstm input proj
        return out(FSDP, "model")
    if leaf == "r":                                      # (H, dh, 4dh)
        return out(None, None, None)
    # ---- fallback -----------------------------------------------------------
    return out(*([None] * len(body)))


def param_shardings(params_shape: Any, mesh, cfg):
    """Same-structure tree of PartitionSpecs for a params (shape) tree,
    such as ``LM(cfg).init(..., device="meta")``."""
    paths, leaves = flatten_with_paths(params_shape)
    return unflatten(params_shape, [
        param_pspec(p, tuple(l.shape), mesh, cfg)
        for p, l in zip(paths, leaves)])


def batch_pspec(mesh) -> PartitionSpec:
    return P(dp_axes(mesh))


def cache_pspec(mesh, cfg, batch: int) -> dict:
    """PartitionSpecs for decode state components."""
    dp = dp_axes(mesh)
    bdim = dp if _div(mesh, batch, dp) else None
    # KV cache (B, S, KV, hd): heads over model when divisible, else the
    # sequence dim (distributed-KV decode for the 500k cell).
    if _div(mesh, cfg.n_kv_heads, "model"):
        kv = P(bdim, None, "model", None)
    else:
        kv = P(bdim, "model" if bdim is not None else ("data", "model"),
               None, None)
    return {
        "kv": kv,
        "mamba_conv": P(bdim, None, "model"),
        "mamba_h": P(bdim, "model", None),
        "mlstm": P(bdim, None, None, None),
        "slstm": P(bdim, None),
        "batch": P(bdim),
    }


def placements(spec, mesh) -> List[Placement]:
    """DTensor placements on ``mesh`` (a ``DeviceMesh``) of a spec.

    Each mesh axis that ``spec`` names on tensor dim ``d`` becomes
    ``Shard(d)``; a tuple of axes on one dim, such as ``("pod",
    "data")``, becomes ``Shard(d)`` on each of those mesh dims, split in
    mesh order — jax's row-major split of a tuple in that order.  Every
    other mesh dim is ``Replicate()``, and so is a mesh dim of size 1 (a
    split into one piece, which DTensor's view rules would still treat as
    a split).
    """
    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    out: List[Placement] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} names mesh axis {names[i]} "
                                 "twice")
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return out


def from_local(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    """The DTensor of global ``shape`` on ``mesh`` by ``placements`` whose
    local shard on this rank is ``local`` (moved to the mesh's device
    type); no collective, so each rank must hold its own shard."""
    shape = torch.Size(shape)
    return DTensor.from_local(
        local.to(mesh.device_type), mesh, placements, run_check=False,
        shape=shape, stride=torch.empty(shape, device="meta").stride())


def distribute_tree(tree: Any, specs: Any, mesh) -> Any:
    """``tree``'s tensors placed on ``mesh`` by the same-structure tree of
    ``specs`` (``param_shardings``' output) as DTensors.

    A tensor holding every position's full value (a ``meta`` tensor, or
    one drawn alike on every rank) is cut to the local shard without a
    collective; the local shards of a ``meta`` tree are ``meta``.  A
    DTensor is redistributed to the spec's placements (a collective
    where it is a partial sum or split otherwise), so every rank calls
    this alike.
    """
    tensors, spec_leaves = flatten_with_paths(tree)[1], \
        flatten_with_paths(specs)[1]
    if len(tensors) != len(spec_leaves):
        raise ValueError("a spec per leaf: trees of different structure")
    return unflatten(tree, [
        t.redistribute(mesh, placements(spec, mesh))
        if isinstance(t, DTensor) else
        distribute_tensor(t, mesh, placements(spec, mesh),
                          src_data_rank=None)
        for t, spec in zip(tensors, spec_leaves)])
