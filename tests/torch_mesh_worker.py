"""One rank of the port's LM on a (2, 2) ``gloo`` DeviceMesh, against the
same LM on plain tensors (used by ``test_torch_mesh.py``).

Run as ``python tests/torch_mesh_worker.py STORE_FILE OUT_JSON CASE...``:
it starts four CPU processes, which meet through ``STORE_FILE`` (a
``FileStore``).  Every rank draws the same parameters and batch from fixed
seeds, runs each case plainly, then again with the parameters placed by
``param_shardings`` (``distribute_tree``) and the batch split over the
data axis, and compares the DTensors' ``full_tensor()`` with the plain
results.  Rank 0 writes each case's largest absolute difference to
``OUT_JSON``.

A case is ``ARCH:KIND:SEQ`` with KIND ``forward`` (logits and aux loss) or
``train`` (one AdamW step with two microbatches: loss, grad norm, the
moments and the new params).  The first AdamW step moves a parameter by
``lr·g/(|g| + eps)``, so where the gradient is at the level of fp32
summation noise (|g| < 1e-6) any two summation orders move it by up to
``lr``; those entries are left out of the new params' difference (the
gradient itself, ``m = 0.1·g``, is compared everywhere) and counted.
"""
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch.mesh import dp_axes, make_device_mesh  # noqa: E402
from repro_torch.launch.sharding import (P, distribute_tree,  # noqa: E402
                                         param_shardings)
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.act_sharding import (  # noqa: E402
    clear_activation_sharding, set_activation_sharding)
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim.adamw import AdamWState  # noqa: E402
from repro_torch.prng import PRNGKey  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

BATCH = 4


def _diff(got, want, keep=None):
    """max |got - want| over two trees, the DTensors of ``got`` gathered
    whole, over the entries where the same-structure tree of masks
    ``keep`` is true (all where it is None)."""
    got, want = flatten_with_paths(got)[1], flatten_with_paths(want)[1]
    keep = flatten_with_paths(keep)[1] if keep is not None else \
        [None] * len(want)
    out = 0.0
    for g, w, k in zip(got, want, keep):
        if not isinstance(w, torch.Tensor):
            continue
        g = g.full_tensor() if hasattr(g, "full_tensor") else g
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)
        d = (g.double() - w.double()).abs()
        if k is not None:
            d = d[k]
        out = max(out, float(d.max()) if d.numel() else 0.0)
    return out


def _case(case, mesh):
    arch, kind, seq = case.split(":")
    cfg = get_smoke_config(arch)
    model = LM(cfg)
    params = model.init(PRNGKey(0), device="cpu")
    rng = np.random.default_rng(1)
    batch = {n: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (BATCH, int(seq))).astype(np.int32))
        for n in ("tokens", "labels")}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (BATCH, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (BATCH, cfg.n_patches, cfg.d_model)).astype(np.float32))
    dparams = distribute_tree(params, param_shardings(params, mesh, cfg),
                              mesh)
    dbatch = distribute_tree(batch, {
        n: P(dp_axes(mesh), *([None] * (t.ndim - 1)))
        for n, t in batch.items()}, mesh)
    if kind == "forward":
        kw = {n: batch[n] for n in ("frames", "patch_embeds") if n in batch}
        dkw = {n: dbatch[n] for n in kw}
        clear_activation_sharding()
        want = model.forward(params, batch["tokens"], **kw)
        set_activation_sharding(dp_axes(mesh), "model", mesh)
        got = model.forward(dparams, dbatch["tokens"], **dkw)
        return {"max_abs": _diff(got, want), "left_out": 0}
    opt_cfg = AdamWConfig()
    opt = adamw_init(params, opt_cfg)
    dopt = AdamWState(
        step=distribute_tree(opt.step, P(), mesh),
        m=distribute_tree(opt.m, param_shardings(params, mesh, cfg), mesh),
        v=distribute_tree(opt.v, param_shardings(params, mesh, cfg), mesh))
    step = S.make_train_step(model, cfg, opt_cfg, n_micro=2)
    clear_activation_sharding()
    want = step(params, opt, batch)
    set_activation_sharding(dp_axes(mesh), "model", mesh)
    got = step(dparams, dopt, dbatch)
    keep = [(m / (1 - opt_cfg.b1)).abs() >= 1e-6
            for m in flatten_with_paths(want[1].m)[1]]
    return {"max_abs": max(_diff(got[2], want[2]), _diff(got[1], want[1]),
                           _diff(got[0], want[0], keep)),
            "left_out": int(sum(int((~k).sum()) for k in keep))}


def _rank(rank, store, out, cases):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=4)
    try:
        mesh = make_device_mesh((2, 2), ("data", "model"))
        res = {c: _case(c, mesh) for c in cases}
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    torch.set_num_threads(1)
    # Forked ranks start with the modules this process imported.
    mp.start_processes(_rank, args=(sys.argv[1], sys.argv[2], sys.argv[3:]),
                       nprocs=4, join=True, start_method="fork")
