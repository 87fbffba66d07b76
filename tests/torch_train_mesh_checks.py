"""The checks of the training driver on four ``gloo`` ranks, shared by
``test_torch_train_mesh.py`` (the ``(4, 1)`` host mesh) and
``test_torch_train_mesh_b.py`` (``(2, 2)``): each module runs
``torch_train_mesh_worker.py`` once for its mesh in a ``train_mesh``
fixture and collects these tests.

* Losses and grad norms per step within rtol 1e-5 of the one-process
  ``train(device="cpu")``: the data-parallel sum adds in another order,
  so no bit-equality is claimed there.
* A run stopped after step 2 and resumed equals the uninterrupted run bit
  for bit (losses, grad norms, and the checkpoint of step 4 leaf by leaf).
* A one-process checkpoint resumes on the mesh.
* A checkpoint written by four ranks restores in one process, and through
  the reference's ``CheckpointManager.restore``, equal to the full
  tensors.
* ``make_global_batch`` gathers to the reference's ``TokenPipeline`` rows
  of the same step.
* Per-shard init (``LM.init`` with the mesh and ``param_shardings``)
  gathers to the one-process draw bit for bit on every rank, and no op on
  a rank makes a tensor larger than its largest shard or the slab
  (``INIT_SLAB``).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro.data import TokenPipeline as RefPipeline
from repro.data import TokenPipelineConfig as RefPipelineConfig
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.tree import flatten_with_paths, tree_map
from torch_train_mesh_worker import (ARCH, ARGS, BATCH_STEPS, INIT_SLAB,
                                     KNOWN_ROWS, KNOWN_STEP, RESUME_AT,
                                     STEPS, known_tree)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5


def run_worker(root: Path, model_parallel: int) -> dict:
    res = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_train_mesh_worker.py"),
         str(root), str(model_parallel)],
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    mesh = root / f"{4 // model_parallel}x{model_parallel}"
    return {"dir": mesh, "data_positions": 4 // model_parallel,
            "one": json.loads((root / "one" / "results.json").read_text()),
            "mesh": json.loads((mesh / "results.json").read_text())}


def _meta_target(tree):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def _assert_bitwise(got, want):
    pg, lg = flatten_with_paths(got)
    pw, lw = flatten_with_paths(want)
    assert pg == pw
    for path, g, w in zip(pg, lg, lw):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert torch.equal(g, w), path


def test_losses_and_grad_norms_match_one_process(train_mesh):
    mesh, one = train_mesh["mesh"]["a"], train_mesh["one"]["a"]
    assert len(mesh["losses"]) == len(mesh["gnorms"]) == STEPS
    np.testing.assert_allclose(mesh["losses"], one["losses"], rtol=RTOL)
    np.testing.assert_allclose(mesh["gnorms"], one["gnorms"], rtol=RTOL)
    assert mesh["losses"][-1] < mesh["losses"][0]


def test_resume_on_the_mesh_is_bit_for_bit(train_mesh):
    r = train_mesh["mesh"]
    for key in ("losses", "gnorms"):
        assert r["b_first"][key] == r["a"][key][:RESUME_AT]
        assert r["b_rest"][key] == r["a"][key][RESUME_AT:]
    params, state = known_tree()
    del params[KNOWN_ROWS]
    target = _meta_target((params, type(state)(state.step, params, params)))
    a, _ = CheckpointManager(str(train_mesh["dir"] / "a")).restore(
        STEPS, target, sharding_fn=lambda path: "cpu")
    b, extras = CheckpointManager(str(train_mesh["dir"] / "b")).restore(
        STEPS, target, sharding_fn=lambda path: "cpu")
    _assert_bitwise(b, a)
    assert extras["pipeline"] == {"step": STEPS, "seed": 0}


def test_one_process_checkpoint_resumes_on_the_mesh(train_mesh):
    got = train_mesh["mesh"]["one"]
    want = train_mesh["one"]["a"]
    np.testing.assert_allclose(got["losses"], want["losses"][RESUME_AT:],
                               rtol=RTOL)
    np.testing.assert_allclose(got["gnorms"], want["gnorms"][RESUME_AT:],
                               rtol=RTOL)


def test_mesh_checkpoint_restores_in_one_process(train_mesh):
    d = train_mesh["dir"] / "known" / f"step_{KNOWN_STEP:08d}"
    assert sorted(os.listdir(d)) == [
        "COMMITTED", "host_0000.npz", "host_0001.npz", "host_0002.npz",
        "host_0003.npz", "meta.json"]
    meta = json.loads((d / "meta.json").read_text())
    # A leaf split over ranks lists a shard of each rank that holds a
    # distinct part; a replicated leaf lists rank 0's alone.
    data = train_mesh["data_positions"]
    stops = {4: [3, 6, 9, 10], 2: [5, 10]}[data]
    assert meta["leaves"][f"0/{KNOWN_ROWS}"]["shards"] == [
        {"key": f"0/{KNOWN_ROWS}::{rank}",
         "index": [[start, stop, None], [None, None, None]]}
        for rank, start, stop in zip(range(0, 4, 4 // data),
                                     [0] + stops[:-1], stops)]
    assert meta["leaves"]["1/.step"]["shards"] == [
        {"key": "1/.step::0", "index": []}]
    want = known_tree()
    got, extras = CheckpointManager(str(train_mesh["dir"] / "known")).restore(
        KNOWN_STEP, _meta_target(want), sharding_fn=lambda path: "cpu")
    _assert_bitwise(got, want)
    assert extras == {"ranks": 4}


def test_reference_restores_a_mesh_checkpoint(train_mesh):
    params, state = known_tree()
    ref_params = tree_map(lambda t: t.numpy(), params)
    target = (jax.tree.map(np.zeros_like, ref_params),
              ref_adamw_init(jax.tree.map(np.zeros_like, ref_params),
                             RefAdamWConfig()))
    (got_p, got_s), extras = RefManager(
        str(train_mesh["dir"] / "known")).restore(KNOWN_STEP, target)
    paths, want = flatten_with_paths((params, state))
    got = flatten_with_paths((got_p, tuple(got_s)))[1]
    assert len(got) == len(want)
    for path, g, w in zip(paths, got, want):
        np.testing.assert_array_equal(np.asarray(g), w.numpy(), err_msg=path)
    assert extras == {"ranks": 4}


def test_global_batch_is_the_reference_rows(train_mesh):
    cfg = RefPipelineConfig(vocab_size=get_smoke_config(ARCH).vocab_size,
                            global_batch=ARGS["batch"],
                            seq_len=ARGS["seq"])
    ref = RefPipeline(cfg, process_index=0, process_count=1)
    for step in BATCH_STEPS:
        ref.step = step
        tokens, _ = ref.next()
        got = np.load(train_mesh["dir"] / f"batch_{step}.npy")
        np.testing.assert_array_equal(got, tokens)


def test_per_shard_init_is_the_whole_draw(train_mesh):
    """Each rank's shards gather to the whole draw bit for bit.  On the
    ``(4, 1)`` mesh ``param_shardings`` replicates every leaf (its FSDP
    axes are ``("pod", "data")``, and a host mesh has no ``pod``); on
    ``(2, 2)`` the model axis splits leaves, and no rank makes a tensor as
    large as the largest whole leaf."""
    ranks = train_mesh["mesh"]["init"]
    split = train_mesh["data_positions"] < 4
    assert len(ranks) == 4
    for r in ranks:
        assert r["equal"]
        assert (r["sharded"] > 0) == split, r
        assert r["max_numel"] <= max(r["max_block"], INIT_SLAB), r
        assert (r["max_numel"] < r["max_leaf"]) == split, r
