"""The dry run's pieces in a process of their own, for the tests of
``test_torch_dryrun*.py`` and ``test_torch_hlo_analysis.py``: a process
has one default process group, and these run on ``fake`` groups.

Run as ``python tests/torch_dryrun_worker.py OUT_JSON TASK...``; writes
one JSON object, a result per task:

* ``shaped:ARCH:MESH`` (MESH ``pod`` or ``multipod``) — every leaf of the
  full config's shaped inputs (params, AdamW state, each shape's batch
  and each applicable shape's decode state): path, global shape, dtype,
  spec and local bytes.
* ``resolve:MESH`` — ``act_sharding._resolve`` on the mesh's
  ``DeviceMesh`` for each role over a range of sizes.
* ``costs`` — the analyzer on DTensor cases of a fake (2, 4) mesh: a
  matmul sharded dp × tp, a reduced partial product, an all-gather, a
  reduce-scatter, and an all-to-all of a local shard.
* ``flopcount:ARCH:SHAPE`` — one smoke-config step on a fake (4, 4) mesh:
  the analyzer's count above DTensor against ``FlopCounterMode``'s.
* ``initshard:ARCH:MESH:RANK`` (MESH ``smoke`` or ``multipod``) — this
  process as rank RANK of the mesh's fake group draws the smoke config's
  shards (``LM.init`` with ``param_shardings``) and holds each against
  the slice of the whole draw that ``distribute_tensor`` cuts there:
  leaves, leaves split, and whether all are equal bit for bit.
"""
import json
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch.mesh import make_device_mesh  # noqa: E402
from repro_torch.models import LM, act_sharding  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402


def _mesh(kind, rank=0):
    shape, axes = D.MESHES[kind]
    D.fake_group(int(torch.tensor(shape).prod()), rank)
    return make_device_mesh(shape, axes)


def _spec(t):
    """Per dim of a DTensor, the mesh axes it is split over, in mesh
    order."""
    from torch.distributed.tensor import Shard

    dims = [[] for _ in range(t.ndim)]
    for name, p in zip(t.device_mesh.mesh_dim_names, t.placements):
        if isinstance(p, Shard):
            dims[p.dim].append(name)
    return dims


def _leaves(tree):
    out = []
    for path, t in zip(*flatten_with_paths(tree)):
        if not isinstance(t, torch.Tensor):
            continue                 # a KV cache's length, the position
        loc = t.to_local()
        out.append([path, list(t.shape), str(t.dtype).split(".")[-1],
                    _spec(t), loc.numel() * loc.element_size()])
    return out


def shaped(arch, kind):
    mesh = _mesh(kind)
    cfg = get_config(arch)
    model = LM(cfg)
    opt_cfg = AdamWConfig()
    out = {"params": _leaves(S.shaped_params(model, mesh)),
           "opt": _leaves(S.shaped_opt_state(model, mesh, opt_cfg))}
    for shape in S.SHAPES:
        out[f"batch/{shape}"] = _leaves(S.batch_specs(cfg, mesh, shape))
        if S.SHAPES[shape]["kind"] == "decode" and \
                S.shape_applicable(cfg, shape)[0]:
            out[f"decode/{shape}"] = _leaves(
                S.shaped_decode_state(model, cfg, mesh, shape))
    return out


def resolve(kind):
    mesh = _mesh(kind)
    act_sharding.set_activation_sharding(("data",) if kind == "pod" else
                                         ("pod", "data"), "model", mesh)
    try:
        return [[r, n, act_sharding._resolve(r, n)]
                for r in ("dp", "tp", None)
                for n in (1, 2, 8, 15, 16, 24, 32, 48, 60, 64, 100, 256)]
    finally:
        act_sharding.clear_activation_sharding()


def costs():
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)

    from repro_torch.launch.hlo_analysis import trace_costs

    D.fake_group(8)
    mesh = make_device_mesh((2, 4), ("data", "model"))

    def dt(shape, pl):
        return distribute_tensor(torch.empty(shape, device="meta"), mesh, pl,
                                 src_data_rank=None)

    x = dt((256, 512), [Shard(0), Replicate()])
    w_col = dt((512, 1024), [Replicate(), Shard(1)])
    w_row = dt((512, 1024), [Replicate(), Shard(0)])
    y = dt((256, 1024), [Shard(0), Shard(1)])

    def run(fn, *args):
        _, c, m, g = trace_costs(fn, *args)
        return {"flops": c.flops, "global_flops": g,
                "coll": c.coll_bytes, "wire": c.wire_bytes,
                "n": c.n_collectives, "mem": c.mem_bytes,
                "argument_bytes": m.argument_bytes}

    return {
        "matmul_dp_tp": run(lambda a, b: a @ b, x, w_col),
        "matmul_reduced": run(lambda a, b: (a @ b).redistribute(
            mesh, [Shard(0), Replicate()]), x, w_row),
        "all_gather": run(lambda a: a.redistribute(
            mesh, [Shard(0), Replicate()]), y),
        "reduce_scatter": run(lambda a, b: (a @ b).redistribute(
            mesh, [Shard(0), Shard(1)]), x, w_row),
        # DTensor on a CPU group gathers instead of an all-to-all: call it.
        "all_to_all": run(lambda a: funcol.all_to_all_single(
            a, None, None, group=mesh.get_group("data")), x.to_local()),
    }


def flopcount(arch, shape):
    from torch.utils.flop_counter import FlopCounterMode

    mesh = _mesh("smoke")
    cfg = get_smoke_config(arch)
    _, c, _, g = D.trace_cell(cfg, shape, mesh)
    step, args = D.cell_step(cfg, shape, mesh)
    act_sharding.set_activation_sharding(("data",), "model", mesh)
    try:
        with FlopCounterMode(display=False) as counter:
            step(*args)
    finally:
        act_sharding.clear_activation_sharding()
    return {"flops": c.flops, "global_flops": g,
            "flop_counter": float(counter.get_total_flops())}


def initshard(arch, kind, rank):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.sharding import param_shardings, placements
    from repro_torch.prng import PRNGKey
    from repro_torch.tree import leaves

    mesh = _mesh(kind, int(rank))
    cfg = get_smoke_config(arch)
    model = LM(cfg)
    specs = param_shardings(S.params_shape(model), mesh, cfg)
    shards = leaves(model.init(PRNGKey(0), device="cpu", mesh=mesh,
                               shardings=specs))
    whole = leaves(model.init(PRNGKey(0), device="cpu"))
    equal = split = 0
    for got, w, spec in zip(shards, whole, leaves(specs)):
        want = distribute_tensor(w, mesh, placements(spec, mesh),
                                 src_data_rank=None).to_local()
        loc = got.to_local()
        equal += loc.dtype == want.dtype and torch.equal(loc, want)
        split += loc.numel() < w.numel()
    return {"leaves": len(whole), "split": split, "equal": equal}


if __name__ == "__main__":
    results = {}
    try:
        for task in sys.argv[2:]:
            name, *rest = task.split(":")
            results[task] = {"shaped": shaped, "resolve": resolve,
                             "costs": costs, "flopcount": flopcount,
                             "initshard": initshard}[name](*rest)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(sys.argv[1], "w") as f:
        json.dump(results, f)
