"""Serving meshes of ``torch.device``s (port of ``repro.launch.mesh``).

A :class:`Mesh` is a numpy array of devices with one named axis per
dimension, the counterpart of ``jax.sharding.Mesh``.  The sharded serving
state (:mod:`repro_torch.core.query.sharding`) row-shards the prefused
partials over the ``"model"`` axis and splits request batches over the
data-parallel axes (``"pod"``, ``"data"``); one process drives every
position, issuing each shard's work on that shard's device.

Two kinds of mesh:

* ``make_serving_mesh(shape)`` takes one card per position,
  ``cuda:0 … cuda:n-1``, and raises when fewer cards exist: a card is never
  used twice and the CPU never stands in for one.
* ``make_serving_mesh(shape, device="cuda:0")`` (or ``"cpu"``) puts every
  position on that one device: a *virtual* mesh.  The shards then run one
  after another on it, and a row-sharded table's blocks are views of one
  tensor.  It is the port's counterpart of the reference's
  ``--xla_force_host_platform_device_count``: the whole sharded program
  runs, on one card or in a CPU test process.

The LM is sharded on a ``torch.distributed`` ``DeviceMesh`` instead
(``make_device_mesh``): one process per position, each holding its
shards as DTensors, over the default process group — ``nccl`` on cards,
``gloo`` in CPU tests, or the ``fake`` group of the dry run, where one
process stands for every position.  ``dp_axes``, ``dp_size`` and the
sharding rules read either kind of mesh through ``axis_sizes``.

``make_host_mesh`` and ``make_production_mesh`` are the reference's
meshes "over whatever devices exist", and there those are the devices of
every process: when the default process group is initialised they return
a ``DeviceMesh`` over its ranks (the training driver's mesh); without
one, a single-process ``Mesh``, as every serving caller uses.
"""
from __future__ import annotations

import collections
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import DeviceLike


def _as_device(d) -> torch.device:
    """``d`` as a ``torch.device``, a CUDA device with its index."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Devices laid out on named axes.

    ``devices`` is a numpy object array of ``torch.device`` of the mesh's
    shape; ``shape`` maps each axis name to its size, in axis order, and is
    read as ``mesh.shape[axis]``, as jax's is.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"devices of shape {arr.shape} need "
                             f"{arr.ndim} axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"duplicate mesh axis names {axis_names}")
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [_as_device(d) for d in arr.reshape(-1)]
        self.devices = flat.reshape(arr.shape)
        self.axis_names: Tuple[str, ...] = axis_names

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(
            (a, int(n)) for a, n in zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """The mesh's physical devices, each once, in position order."""
        return tuple(dict.fromkeys(self.devices.reshape(-1)))

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({axes}; devices={self.distinct_devices()})"


def production_mesh_shape(*, multi_pod: bool = False):
    """(shape, axis names) of the reference's production mesh: (16, 16) =
    256 positions over ``("data", "model")``, or (2, 16, 16) over
    ``("pod", "data", "model")``."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def _group_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh: a ``DeviceMesh`` over the default process
    group when there is one (raises unless it has the mesh's 256 or 512
    ranks), else one card per position (raises where fewer cards
    exist)."""
    if _group_initialized():
        return make_device_mesh(*production_mesh_shape(multi_pod=multi_pod))
    return make_serving_mesh(*production_mesh_shape(multi_pod=multi_pod))


def make_device_mesh(shape, axes, device_type: Optional[str] = None
                     ) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over the named ``axes``, on the
    default process group, whose size must be the mesh's.

    ``device_type`` defaults to ``"cuda"`` on an ``nccl`` group and
    ``"cpu"`` otherwise (``gloo``, or the dry run's ``fake`` group).
    """
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not fit axes {axes}")
    if not dist.is_initialized():
        raise RuntimeError("make_device_mesh needs the default process "
                           "group (torch.distributed.init_process_group)")
    n = int(np.prod(shape))
    if n != dist.get_world_size():
        raise ValueError(f"mesh shape {shape} needs a group of {n}, the "
                         f"default group has {dist.get_world_size()}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of a ``Mesh`` or a ``DeviceMesh``, in axis order."""
    if isinstance(mesh, DeviceMesh):
        return tuple(mesh.mesh_dim_names)
    return tuple(mesh.axis_names)


def axis_sizes(mesh) -> "collections.OrderedDict[str, int]":
    """Axis name → size, in axis order, of a ``Mesh`` or a
    ``DeviceMesh`` (a jax mesh's ``shape``)."""
    if isinstance(mesh, DeviceMesh):
        return collections.OrderedDict(
            zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))
    return collections.OrderedDict(mesh.shape)


def make_host_mesh(model_parallel: int = 1, *, device: DeviceLike = None):
    """A small ``(data, model)`` mesh for tests and examples.

    With the default process group initialised: a ``DeviceMesh`` of
    ``(W // mp, mp)`` over its ``W`` ranks, ``mp = min(model_parallel,
    W)`` (``device`` is then each rank's own, set by the caller).
    Without one, ``device=None``: over every card there is,
    ``model_parallel`` of them per model group (raises without a card);
    with ``device``: a virtual ``(1, model_parallel)`` mesh on that
    device.
    """
    if _group_initialized():
        n = dist.get_world_size()
        mp = min(max(int(model_parallel), 1), n)
        return make_device_mesh((n // mp, mp), ("data", "model"))
    if device is not None:
        return make_serving_mesh((1, max(int(model_parallel), 1)),
                                 device=device)
    n = torch.cuda.device_count()
    if n < 1:
        raise ValueError("make_host_mesh: no CUDA device; pass device='cpu' "
                         "for a virtual mesh on the CPU")
    mp = min(max(int(model_parallel), 1), n)
    return make_serving_mesh((n // mp, mp))


def make_serving_mesh(shape, axes=("data", "model"), *,
                      device: DeviceLike = None) -> Mesh:
    """A serving mesh of any shape over ``axes``.

    ``device=None`` takes one card per position and raises when
    ``torch.cuda.device_count()`` is smaller than the mesh; with
    ``device`` every position is that device (a virtual mesh).
    """
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(tuple(axes)) or any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} does not fit axes "
                         f"{tuple(axes)}")
    n = int(np.prod(shape))
    if device is None:
        have = torch.cuda.device_count()
        if n > have:
            raise ValueError(
                f"mesh shape {shape} needs {n} CUDA devices, have {have}; "
                "pass device=... to place every position on one device")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [_as_device(device)] * n
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axes)


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh (pod folds into DP)."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    out = 1
    for a in dp_axes(mesh):
        out *= sizes[a]
    return out


def dp_position(mesh) -> Tuple[int, int]:
    """(this process's position along the flattened data-parallel axes,
    their size): the slice of a global batch this process reads.  Ranks
    that differ only along other axes (``"model"``) share a position.  A
    single-process ``Mesh`` holds the whole batch: ``(0, 1)``."""
    if not isinstance(mesh, DeviceMesh):
        return 0, 1
    sizes = axis_sizes(mesh)
    coord = dict(zip(axis_names(mesh), mesh.get_coordinate()))
    index = 0
    for a in dp_axes(mesh):
        index = index * sizes[a] + coord[a]
    return index, dp_size(mesh)


def device_grid(mesh, shard_axis: Optional[str]) -> Tuple[Tuple, ...]:
    """The mesh's devices as ``(dp rows, model shards)``.

    Row ``i`` is the ``i``-th position of the flattened data-parallel axes
    (in ``dp_axes`` order, as a batch is split over them) and column ``s``
    the ``s``-th position of ``shard_axis`` (one column when the mesh has
    no such axis); every other axis is taken at position 0 (the work is
    replicated along it).
    """
    names = list(mesh.axis_names)
    dp = list(dp_axes(mesh))
    shard = [shard_axis] if shard_axis in names and shard_axis not in dp \
        else []
    rest = [a for a in names if a not in dp and a not in shard]
    order = [names.index(a) for a in dp + shard + rest]
    arr = mesh.devices.transpose(order)
    n_dp = int(np.prod([mesh.shape[a] for a in dp])) if dp else 1
    n_sh = mesh.shape[shard[0]] if shard else 1
    arr = arr.reshape(n_dp, n_sh, -1)[:, :, 0]
    return tuple(tuple(row) for row in arr)
