"""Checkpointing: atomic, async, placed on restore (port of
``repro.checkpoint.manager``).

Layout (one directory per step), the reference's::

    <dir>/step_00000100/
        host_0000.npz        # this process's shards of every leaf
        meta.json            # per leaf: global shape, dtype, shards; extras
        COMMITTED            # written last — partial checkpoints are ignored

A step is written into ``step_XXXXXXXX.tmp`` and renamed into place, then
``COMMITTED`` is written.  Leaf paths are the reference's
(:mod:`repro_torch.tree`: sorted dict keys, ``.field`` for a NamedTuple,
``/``-joined).  A plain tensor is one shard, ``<path>::0``, covering the
whole array.

Across ranks (a ``torch.distributed`` group, leaves that are DTensors):
rank ``r`` writes its local shard of each DTensor leaf as
``<path>::<r>`` with its global index into ``host_{r:04d}.npz``, as the
reference writes each process's addressable shards; a leaf replicated
along some mesh dims is written only by the rank at position 0 of those
dims, and a plain leaf only by rank 0.  ``meta.json`` lists every rank's
shards: the lists are gathered on the main thread in ``save``/
``save_async``, which every rank calls at the same step.  Rank 0 alone
commits: its writer thread waits (no collective) until every rank's file
is in the ``.tmp`` directory, then writes ``meta.json``, renames and
writes ``COMMITTED``, and drops old steps; the other ranks' writer
threads wait for that commit.  A one-process checkpoint is the layout
above (one ``host_0000.npz``).

* ``save_async`` copies every leaf to host memory before it returns (a
  card's tensors through pinned buffers), then writes the files in a
  background thread: the train loop blocks only for the copy.
* ``restore`` reads each leaf whole, assembling the shards of every
  rank's file, and places it on ``sharding_fn(path)`` — a
  ``torch.device``, or a ``(DeviceMesh, placements)`` pair — or where
  the target leaf is: a DTensor target leaf gives its mesh and
  placements (each rank keeps its local shard, no collective), the
  counterpart of the reference's ``getattr(leaf, "sharding")``, and a
  plain one its device.  A target leaf on ``meta`` gives the shape alone
  and needs ``sharding_fn`` (or takes the card).
* Retention: keep the newest ``keep`` checkpoints.

dtypes.  fp32 and integer leaves are stored as numpy arrays of their
dtype, so either package restores the other's.  numpy has no bfloat16: a
bf16 leaf is stored as its raw 16 bits, a 2-byte void array, with
``"bfloat16"`` in ``meta.json`` — byte for byte what the reference writes
for its own bf16 leaves.  The port restores a bf16 leaf of either package
bit for bit (it reads the 16 bits back as bf16).  The reference's restore
cannot cast the void array to bfloat16 and raises, for its own bf16
checkpoints and the port's alike.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..tree import flatten_with_paths, unflatten

_BITS16 = {"bfloat16": torch.bfloat16}
#: Longest a writer thread waits for the other ranks' files or the commit.
COMMIT_TIMEOUT_S = 900.0


def _rank_world():
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _local_box(shape, mesh, placements, coord):
    """(local shape, global offset) of the shard at mesh coordinate
    ``coord`` of a tensor of ``shape`` placed by ``placements``: DTensor's
    ``Shard`` split (``torch.chunk`` sizes, mesh dims in order)."""
    from torch.distributed.tensor import Replicate, Shard
    size, offset = list(shape), [0] * len(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            d, k = p.dim, mesh.size(i)
            chunk = -(-size[d] // k)
            start = min(coord[i] * chunk, size[d])
            offset[d] += start
            size[d] = min(start + chunk, size[d]) - start
        elif not isinstance(p, Replicate):
            raise ValueError(f"checkpoint: a leaf placed {p} (only Shard "
                             "and Replicate are saved)")
    return size, offset


def _box_index(size, offset, shape):
    """The reference's JSON index of a shard: ``[start, stop, step]`` per
    dim, ``[None, None, None]`` where it holds the whole dim."""
    return [[None, None, None] if n == full else [o, o + n, None]
            for n, o, full in zip(size, offset, shape)]


def _shard(t, rank):
    """(local tensor or None when this rank does not write the leaf,
    its JSON index) of leaf ``t``; a partial sum is reduced first."""
    if not _is_dtensor(t):
        return (t if rank == 0 else None), [[None, None, None]] * t.dim()
    from torch.distributed.tensor import Replicate, Shard
    if any(p.is_partial() for p in t.placements):  # a collective
        t = t.redistribute(t.device_mesh, [
            Replicate() if p.is_partial() else p for p in t.placements])
    mesh, placements = t.device_mesh, t.placements
    coord = mesh.get_coordinate()
    size, offset = _local_box(t.shape, mesh, placements, coord)
    local = t.to_local()
    if list(local.shape) != size:
        raise ValueError(f"checkpoint: local shard {tuple(local.shape)} "
                         f"of a {tuple(t.shape)} leaf, expected "
                         f"{tuple(size)}")
    writes = all(c == 0 for c, p in zip(coord, placements)
                 if not isinstance(p, Shard))
    return (local if writes else None), _box_index(size, offset,
                                                   t.shape)


def _to_numpy(t: torch.Tensor, pinned: bool) -> np.ndarray:
    """A host copy of ``t`` that later writes to ``t`` cannot change."""
    if t.device.type == "cuda" and pinned:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)     # the caller synchronizes
    else:
        host = t.detach().to("cpu", copy=True)
    if t.dtype in _BITS16.values():
        return host.view(torch.int16).numpy().view("V2")
    return host.numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- save ----
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def save(self, step: int, tree: Any, extras: Optional[dict] = None):
        """Synchronous save (host copies + metadata)."""
        self.wait()
        host_data, meta = self._snapshot(step, tree, extras, pinned=False)
        self._write(step, host_data, meta)

    def save_async(self, step: int, tree: Any, extras: Optional[dict] = None):
        """Device→host copy now; file I/O in a background thread."""
        self.wait()
        host_data, meta = self._snapshot(step, tree, extras, pinned=True)
        self._thread = threading.Thread(
            target=self._write, args=(step, host_data, meta), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _snapshot(self, step, tree, extras, pinned):
        rank, world = _rank_world()
        paths, leaves = flatten_with_paths(tree)
        host_data = {}
        leaf_meta = {}
        copied_from_card = False
        for path, leaf in zip(paths, leaves):
            if not _is_dtensor(leaf):
                leaf = torch.as_tensor(leaf)
            local, index = _shard(leaf, rank)
            leaf_meta[path] = {
                "shape": list(leaf.shape),
                "dtype": str(leaf.dtype).removeprefix("torch."),
                "shards": [],
            }
            if local is not None:
                key = f"{path}::{rank}"
                host_data[key] = _to_numpy(local, pinned)
                leaf_meta[path]["shards"].append({"key": key,
                                                  "index": index})
                copied_from_card |= local.is_cuda
        if pinned and copied_from_card:
            torch.cuda.synchronize()         # the pinned copies are done
        if world > 1:
            if rank == 0:                    # before any rank may write
                shutil.rmtree(self._step_dir(step) + ".tmp",
                              ignore_errors=True)
            mine = {p: m["shards"] for p, m in leaf_meta.items()}
            every = [None] * world
            torch.distributed.all_gather_object(every, mine)
            for path, m in leaf_meta.items():
                m["shards"] = [s for shards in every for s in shards[path]]
        meta = {"step": step, "leaves": leaf_meta, "extras": extras or {},
                "process_index": rank}
        return host_data, meta

    def _write(self, step, host_data, meta):
        rank, world = _rank_world()
        d = self._step_dir(step)
        tmp = d + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        name = os.path.join(tmp, f"host_{rank:04d}.npz")
        if world == 1:
            np.savez(name, **host_data)
        else:                                # whole, or not there at all
            with open(name + ".part", "wb") as f:
                np.savez(f, **host_data)
            os.replace(name + ".part", name)
            if rank != 0:
                _wait_for(lambda: not os.path.exists(tmp) and os.path.exists(
                    os.path.join(d, "COMMITTED")), f"step {step}'s commit")
                return
            _wait_for(lambda: all(os.path.exists(os.path.join(
                tmp, f"host_{r:04d}.npz")) for r in range(world)),
                f"every rank's file of step {step}")
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        # Atomic commit: rename, then marker file.
        if os.path.exists(d):
            shutil.rmtree(d)
        os.replace(tmp, d)
        with open(os.path.join(d, "COMMITTED"), "w") as f:
            f.write("ok")
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ---------------------------------------------------------- restore ----
    def all_steps(self):
        out = []
        for name in sorted(os.listdir(self.dir)):
            m = re.match(r"step_(\d+)$", name)
            if m and os.path.exists(os.path.join(self.dir, name, "COMMITTED")):
                out.append(int(m.group(1)))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Any,
                sharding_fn: Optional[Callable[[str], Any]] = None):
        """Restore into the structure of ``target`` (tensors, ``meta``
        tensors for the shapes alone), each leaf on ``sharding_fn(path)``
        or on the target leaf's device.  Returns (tree, extras)."""
        d = self._step_dir(step)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        files = [np.load(os.path.join(d, name))
                 for name in sorted(os.listdir(d)) if name.endswith(".npz")]
        paths, leaves = flatten_with_paths(target)
        out = []
        for path, leaf in zip(paths, leaves):
            info = meta["leaves"][path]
            bits16 = _BITS16.get(info["dtype"])
            np_dtype = np.int16 if bits16 else np.dtype(info["dtype"])
            shape = tuple(info["shape"])
            full = None
            for shard in info["shards"]:
                for f in files:
                    if shard["key"] in f:
                        part = f[shard["key"]]
                        if bits16:
                            part = part.view(np.int16)
                        if full is None and part.shape == shape:
                            full = part       # one shard holds the leaf
                        else:
                            if full is None:
                                full = np.zeros(shape, np_dtype)
                            full[_index_from_json(shard["index"])] = part
                        break
            if full is None:
                full = np.zeros(shape, np_dtype)
            place = sharding_fn(path) if sharding_fn else None
            if place is None and _is_dtensor(leaf):
                place = (leaf.device_mesh, leaf.placements)
            if isinstance(place, tuple):
                out.append(_place_on_mesh(full, bits16, np_dtype, *place))
                continue
            t = torch.from_numpy(np.require(full, np_dtype, ["C", "W"]))
            if bits16:
                t = t.view(bits16)
            dev = torch.device(place) if place is not None else leaf.device
            if dev.type == "meta":
                dev = resolve_device(None)
            out.append(t.to(dev))
        for f in files:
            f.close()
        return unflatten(target, out), meta["extras"]


def _place_on_mesh(full, bits16, np_dtype, mesh, placements):
    """The DTensor of the whole array ``full`` on ``mesh`` by
    ``placements``: each rank cuts its own shard, no collective."""
    from ..launch.sharding import from_local
    size, offset = _local_box(full.shape, mesh, placements,
                              mesh.get_coordinate())
    box = tuple(slice(o, o + n) for o, n in zip(offset, size))
    t = torch.from_numpy(np.require(full[box], np_dtype, ["C", "W"]))
    if bits16:
        t = t.view(bits16)
    return from_local(t, mesh, placements, full.shape)


def _wait_for(ready: Callable[[], bool], what: str):
    deadline = time.monotonic() + COMMIT_TIMEOUT_S
    while not ready():
        if time.monotonic() > deadline:
            raise TimeoutError(f"checkpoint: waited {COMMIT_TIMEOUT_S} s "
                               f"for {what}")
        time.sleep(0.01)


def _index_from_json(idx):
    return tuple(slice(a, b, c) for a, b, c in idx)
