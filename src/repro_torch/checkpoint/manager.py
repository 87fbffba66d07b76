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
``/``-joined).  The port holds every leaf whole on one device, so each
leaf is one shard, ``<path>::0``, covering the whole array.

* ``save_async`` copies every leaf to host memory before it returns (a
  card's tensors through pinned buffers), then writes the files in a
  background thread: the train loop blocks only for the copy.
* ``restore`` reads each leaf whole, assembling the shards a reference
  checkpoint may hold, and places it on ``sharding_fn(path)`` (a
  ``torch.device``) or on the target leaf's device.  A target leaf on
  ``meta`` gives the shape alone and needs ``sharding_fn`` (or takes the
  card).
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
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..tree import flatten_with_paths, unflatten

_BITS16 = {"bfloat16": torch.bfloat16}


def _process_index() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


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
        paths, leaves = flatten_with_paths(tree)
        host_data = {}
        leaf_meta = {}
        for path, leaf in zip(paths, leaves):
            t = torch.as_tensor(leaf)
            key = f"{path}::0"
            host_data[key] = _to_numpy(t, pinned)
            leaf_meta[path] = {
                "shape": list(t.shape),
                "dtype": str(t.dtype).removeprefix("torch."),
                "shards": [{"key": key,
                            "index": [[None, None, None]] * t.dim()}],
            }
        if pinned and any(isinstance(t, torch.Tensor) and t.is_cuda
                          for t in leaves):
            torch.cuda.synchronize()         # the pinned copies are done
        meta = {"step": step, "leaves": leaf_meta, "extras": extras or {},
                "process_index": _process_index()}
        return host_data, meta

    def _write(self, step, host_data, meta):
        d = self._step_dir(step)
        tmp = d + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(
            tmp, f"host_{meta['process_index']:04d}.npz"), **host_data)
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
            t = torch.from_numpy(np.require(full, np_dtype, ["C", "W"]))
            if bits16:
                t = t.view(bits16)
            dev = (torch.device(sharding_fn(path)) if sharding_fn
                   else leaf.device)
            if dev.type == "meta":
                dev = resolve_device(None)
            out.append(t.to(dev))
        for f in files:
            f.close()
        return unflatten(target, out), meta["extras"]


def _index_from_json(idx):
    return tuple(slice(a, b, c) for a, b, c in idx)
