"""Activation sharding constraints, injected by the launch layer (port of
``repro.models.act_sharding``).

Model code calls ``constrain(x, "dp", None, "tp")`` with logical axis roles;
the launch layer maps roles to the concrete mesh axes
(``set_activation_sharding``).  On a DTensor (the LM placed on a
``DeviceMesh`` by ``launch.sharding.distribute_tree``) ``constrain``
redistributes it to the roles' placements, the port's
``with_sharding_constraint``; on a plain tensor, or outside a mesh context
(unit tests, CPU examples, one-position training and serving), it is the
identity.  It never changes a value.

Without these constraints nothing keeps the (B, S, V) logits or the loss
intermediates sharded.

The other helpers let the model code run on DTensors and plain tensors
alike (each is the plain op on a plain tensor): ``lift`` puts a constant
beside a DTensor operand; ``unflatten`` splits a sharded dim whose leading
part does not divide its mesh axes (smollm's 15 heads on a 16-wide axis)
and ``flatten`` joins dims so that its gradient can be split back;
``local`` runs a region of plain-tensor code on each position's shards,
and ``shard_start`` says where a position's shard begins.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..launch.mesh import axis_sizes
from ..launch.sharding import P, placements

_CTX = {"dp": None, "tp": None, "mesh": None}


def set_activation_sharding(dp_axes: Optional[Tuple[str, ...]],
                            tp_axis: Optional[str], mesh=None):
    _CTX["dp"] = tuple(dp_axes) if dp_axes else None
    _CTX["tp"] = tp_axis
    _CTX["mesh"] = mesh


def clear_activation_sharding():
    set_activation_sharding(None, None, None)


def _resolve(role, size: int):
    if role is None:
        return None
    axes = _CTX["dp"] if role == "dp" else (
        (_CTX["tp"],) if _CTX["tp"] else None)
    if not axes:
        return None
    mesh = _CTX["mesh"]
    if mesh is not None:
        sizes = axis_sizes(mesh)
        total = 1
        for a in axes:
            total *= sizes[a]
        if size % total != 0:
            return None
    return axes if len(axes) > 1 else axes[0]


def constrain(x: torch.Tensor, *roles) -> torch.Tensor:
    """with_sharding_constraint by logical role ("dp"/"tp"/None) per dim:
    a DTensor is redistributed to the roles' placements (a ``Partial`` is
    reduced), a plain tensor is returned as it is."""
    if _CTX["dp"] is None and _CTX["tp"] is None:
        return x
    if not isinstance(x, DTensor):
        return x
    spec = P(*[_resolve(r, d) for r, d in zip(roles, x.shape)])
    want = placements(spec, x.device_mesh)
    if tuple(x.placements) == tuple(want):
        return x
    # A redistributed shard can be a strided view; later views need it
    # dense.
    return x.redistribute(x.device_mesh, want).contiguous()


def lift(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t``, a constant that every position holds whole, as a replicated
    DTensor on ``like``'s mesh when ``like`` is a DTensor; ``t`` itself
    otherwise."""
    if not isinstance(like, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def unflatten(x: torch.Tensor, dim: int, sizes: Sequence[int]
              ) -> torch.Tensor:
    """``x.unflatten(dim, sizes)``.  A DTensor sharded on ``dim`` over mesh
    dims whose product does not divide ``sizes[0]`` is first gathered on
    them: the split can only keep a shard on its leading part."""
    if isinstance(x, DTensor):
        dim = dim % x.ndim
        mesh_dims = [i for i, p in enumerate(x.placements)
                     if isinstance(p, Shard) and p.dim == dim]
        total = 1
        for i in mesh_dims:
            total *= x.device_mesh.size(i)
        if sizes[0] % total:
            want = [Replicate() if i in mesh_dims else p
                    for i, p in enumerate(x.placements)]
            x = x.redistribute(x.device_mesh, want)
    return x.unflatten(dim, tuple(sizes))


def flatten(x: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """``x.flatten(start, end)``.  On a DTensor, shards of the dims after
    ``start`` in the range are gathered first, and the flatten runs on the
    shards: its gradient then comes back on the same placements (DTensor
    would otherwise have to split a gradient sharded on the flat dim, which
    it cannot where ``unflatten`` gathered)."""
    if not isinstance(x, DTensor):
        return x.flatten(start, end)
    start, end = start % x.ndim, end % x.ndim
    keep = [Replicate() if isinstance(p, Shard) and start < p.dim <= end
            else p for p in x.placements]
    if keep != list(x.placements):
        x = x.redistribute(x.device_mesh, keep)
    out = [Shard(p.dim - (end - start) if p.dim > end else p.dim)
           if isinstance(p, Shard) else p for p in keep]
    return local(lambda t: t.flatten(start, end), out, x)


def shard_start(x: DTensor, dim: int) -> Tuple[int, List[int]]:
    """(this position's first index along ``dim``, the mesh dims ``dim``
    is sharded over) of an evenly sharded DTensor."""
    mesh = x.device_mesh
    mesh_dims = [i for i, p in enumerate(x.placements)
                 if isinstance(p, Shard) and p.dim == dim]
    start, n = 0, x.shape[dim]
    for i in mesh_dims:                  # mesh order: the major split first
        n //= mesh.size(i)
        start += mesh.get_local_rank(i) * n
    return start, mesh_dims


def local(fn: Callable, out_placements, *args):
    """``fn(*args)`` on each position's local shards.

    With no DTensor among ``args`` this is ``fn(*args)``.  Otherwise every
    DTensor argument is passed as its local tensor and each tensor ``fn``
    returns is wrapped as a DTensor with the matching entry of
    ``out_placements`` (one placement list, or a tuple of them for a tuple
    of outputs), on the first DTensor argument's mesh.  The caller
    redistributes the arguments first so that the region is exact on its
    shards (``fn`` works per batch row, per head, ...); gradients flow
    through both ends.
    """
    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return fn(*args)
    mesh = dts[0].device_mesh
    # A mesh dim over which some argument is split: the positions along it
    # work on different rows, so an argument replicated over it gets a
    # partial gradient on each.
    split = {i for a in dts for i, p in enumerate(a.placements)
             if isinstance(p, Shard)}

    def to_local(a):
        if not isinstance(a, DTensor):
            return a
        return a.to_local(grad_placements=[
            Partial() if isinstance(p, Replicate) and i in split else p
            for i, p in enumerate(a.placements)])

    out = fn(*[to_local(a) for a in args])

    def wrap(t, pl):
        return DTensor.from_local(t, mesh, pl, run_check=False)

    if isinstance(out, torch.Tensor):
        return wrap(out, out_placements)
    return tuple(wrap(t, pl) for t, pl in zip(out, out_placements))
