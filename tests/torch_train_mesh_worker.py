"""The port's training driver on four ``gloo`` ranks, and the same driver in
one process (used by ``test_torch_train_mesh.py``).

Run as ``python tests/torch_train_mesh_worker.py ROOT MP...``: a forked
child first trains the smoke smollm-360m in one process
(``train(device="cpu")``, no process group) into ``ROOT/one``; then four
forked CPU ranks meet through a ``FileStore`` and, for each ``MP``, run
``train()`` on the ``(4 // MP, MP)`` host mesh (the worker sets
``model_parallel`` by wrapping ``make_host_mesh``; the driver has no such
knob):

* ``a``: the uninterrupted run, checkpoints every 2 steps;
* ``b``: the same run stopped after step 2 and resumed;
* ``one``: a resume on the mesh from the one-process checkpoint of step 2;
* the global batch of two steps through ``make_global_batch``, gathered
  whole (``batch_<step>.npy``);
* ``known``: a tree of seeded tensors, placed by ``param_shardings``
  (AdamW moments on the same specs) and one leaf split over the data
  axes, saved by every rank at step 7;
* ``init``: the smoke config's parameters drawn per shard on the mesh
  (``LM.init(..., mesh=, shardings=)``, with slabs of ``INIT_SLAB``
  elements) under a dispatch mode that records the largest tensor any op
  made on the rank, and gathered whole (``full_tensor``) to compare with
  the one-process draw.

Every run records its losses and grad norms (the worker wraps
``make_train_step`` to read each step's metrics).  Rank 0 writes them to
``ROOT/<tag>/results.json`` (``ROOT/one/results.json`` for the
one-process run).
"""
import functools
import json
import os
import shutil
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import (TokenPipeline,  # noqa: E402
                              TokenPipelineConfig, make_global_batch)
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.launch.mesh import dp_position, make_host_mesh  # noqa: E402
from repro_torch.launch.sharding import (P, batch_pspec,  # noqa: E402
                                         distribute_tree, param_shardings)
from repro_torch import prng  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.optim import AdamWConfig, AdamWState, adamw_init  # noqa: E402
from repro_torch.prng import PRNGKey  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

ARCH = "smollm-360m"
ARGS = dict(arch=ARCH, smoke=True, batch=8, seq=32, lr=3e-3, log_every=100,
            device="cpu")
STEPS, CKPT_EVERY, RESUME_AT = 4, 2, 2
BATCH_STEPS = (0, 3)
KNOWN_STEP = 7
KNOWN_ROWS = "rows"
#: Slab size of the per-shard draw: far below the leaves' sizes, so the
#: slab tiling runs and every temporary is smaller than a shard.
INIT_SLAB = 1 << 10


def known_tree():
    """Seeded parameters of the smoke config, plus ``rows`` (10 rows, split
    over the data axes unevenly on four of them), and AdamW moments that
    are not zero: the tree the ``known`` checkpoint holds."""
    cfg = get_smoke_config(ARCH)
    params = LM(cfg).init(PRNGKey(11), device="cpu")
    params[KNOWN_ROWS] = prng.truncated_normal(PRNGKey(12), -2.0, 2.0,
                                               (10, 5))
    state = adamw_init(params, AdamWConfig())
    return params, AdamWState(step=state.step + 5,
                              m=tree_map(lambda p: p * 0.5, params),
                              v=tree_map(lambda p: p * p, params))


_NORMS = []
_make_train_step = S.make_train_step


def _recording_train_step(*args, **kwargs):
    step_fn = _make_train_step(*args, **kwargs)

    def step(*a):
        out = step_fn(*a)
        _NORMS.append(float(T._whole(out[2]["grad_norm"])))
        return out
    return step


def _run(ckpt_dir, steps):
    _NORMS.clear()
    losses = T.train(steps=steps, ckpt_dir=ckpt_dir, ckpt_every=CKPT_EVERY,
                     **ARGS)
    return {"losses": losses, "gnorms": list(_NORMS)}


class _Largest(TorchDispatchMode):
    """The most elements of any tensor in memory an op makes (a DTensor's
    local shard; a ``meta`` tensor holds no memory)."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, DTensor):
                t = t.to_local()
            if isinstance(t, torch.Tensor) and not t.is_meta:
                self.numel = max(self.numel, t.numel())
        return out


def _init_case(mesh, cfg):
    """Per-shard init on ``mesh`` against the one-process draw: whether
    every leaf gathers to it bit for bit, the largest tensor made on this
    rank, this rank's largest shard and the largest whole leaf."""
    model = LM(cfg)
    specs = param_shardings(S.params_shape(model), mesh, cfg)
    slab, prng.SLAB = prng.SLAB, INIT_SLAB
    try:
        with _Largest() as largest:
            sharded = model.init(PRNGKey(0), device="cpu", mesh=mesh,
                                 shardings=specs)
    finally:
        prng.SLAB = slab
    whole = leaves(model.init(PRNGKey(0), device="cpu"))
    shards = leaves(sharded)
    return {"equal": all(torch.equal(s.full_tensor(), w)
                         for s, w in zip(shards, whole)),
            "sharded": sum(s.to_local().numel() < w.numel()
                           for s, w in zip(shards, whole)),
            "max_numel": largest.numel,
            "max_block": max(s.to_local().numel() for s in shards),
            "max_leaf": max(w.numel() for w in whole)}


def _one(rank, root):
    torch.set_num_threads(1)
    res = {"a": _run(os.path.join(root, "one", "a"), STEPS)}
    with open(os.path.join(root, "one", "results.json"), "w") as f:
        json.dump(res, f)


def _mesh_case(root, model_parallel, rank):
    tag = f"{4 // model_parallel}x{model_parallel}"
    d = os.path.join(root, tag)
    T.make_host_mesh = functools.partial(make_host_mesh, model_parallel)
    res = {"a": _run(os.path.join(d, "a"), STEPS),
           "b_first": _run(os.path.join(d, "b"), RESUME_AT),
           "b_rest": _run(os.path.join(d, "b"), STEPS),
           "one": _run(os.path.join(d, "one"), STEPS)}
    mesh = make_host_mesh(model_parallel)
    cfg = get_smoke_config(ARCH)
    index, count = dp_position(mesh)
    pipe = TokenPipeline(TokenPipelineConfig(cfg.vocab_size, ARGS["batch"],
                                             ARGS["seq"]),
                         process_index=index, process_count=count)
    for step in BATCH_STEPS:
        pipe.restore({"step": step, "seed": 0})
        tokens, _ = pipe.next()
        full = make_global_batch(tokens, mesh, batch_pspec(mesh)).full_tensor()
        if rank == 0:
            np.save(os.path.join(d, f"batch_{step}.npy"), full.numpy())
    params, state = known_tree()
    specs = param_shardings({k: v for k, v in params.items()
                             if k != KNOWN_ROWS}, mesh, cfg)
    specs[KNOWN_ROWS] = batch_pspec(mesh)
    placed = distribute_tree((params, state),
                             (specs, AdamWState(P(), specs, specs)), mesh)
    CheckpointManager(os.path.join(d, "known")).save(
        KNOWN_STEP, placed, extras={"ranks": dist.get_world_size()})
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, _init_case(mesh, cfg))
    res["init"] = ranks
    if rank == 0:
        with open(os.path.join(d, "results.json"), "w") as f:
            json.dump(res, f)


def _rank(rank, store, root, model_parallels):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=4)
    try:
        for mp_ in model_parallels:
            _mesh_case(root, mp_, rank)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    root, mps = sys.argv[1], [int(a) for a in sys.argv[2:]]
    S.make_train_step = _recording_train_step
    os.makedirs(os.path.join(root, "one"), exist_ok=True)
    # Forked processes start with the modules this process imported; this
    # one runs no torch op before it forks.
    mp.start_processes(_one, args=(root,), nprocs=1, join=True,
                       start_method="fork")
    step_dir = f"step_{RESUME_AT:08d}"
    for mp_ in mps:
        dst = os.path.join(root, f"{4 // mp_}x{mp_}", "one", step_dir)
        shutil.copytree(os.path.join(root, "one", "a", step_dir), dst)
    mp.start_processes(_rank, args=(os.path.join(root, "store"), root, mps),
                       nprocs=4, join=True, start_method="fork")
