"""Port parity: the dry run's shaped inputs (``shaped_params``,
``shaped_opt_state``, ``batch_specs``, ``shaped_decode_state`` of
``repro_torch.launch.steps``) against the reference's, for all ten full
configs, every shape and both production meshes.

The port's are ``meta`` DTensors on a ``DeviceMesh`` over a ``fake``
process group, built in a subprocess (``torch_dryrun_worker.py``: a
process has one default group); the reference's are ``ShapeDtypeStruct``s
with ``NamedSharding``s on a ``jax.sharding.AbstractMesh`` of the same
shape.  Per leaf, in the reference's order (``tree.py``): the path, the
global shape, the dtype and the placement (the mesh axes each dim is split
over), and the per-device bytes against Σ ``NamedSharding.shard_shape``
bytes.  A KV cache's length and the decode position are Python ints in
the port (``attention.py``'s docstring); the reference's arrays for them
(a length per repeat, a 0-d position) are left out.
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import arch_ids
from repro.configs import get_config as ref_get_config
from repro.launch import steps as RS
from repro.models import LM as RefLM
from repro.optim import AdamWConfig as RefAdamWConfig

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def port_inputs(tmp_path_factory):
    out = tmp_path_factory.mktemp("shaped") / "shaped.json"
    tasks = [f"shaped:{a}:{m}" for a in arch_ids() for m in MESHES]
    res = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_dryrun_worker.py"),
         str(out)] + tasks, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(out.read_text())


def _norm(spec, ndim):
    """Per dim, the mesh axes it is split over (a list, empty if whole)."""
    out = []
    for d in range(ndim):
        e = spec[d] if d < len(spec) else None
        out.append([] if e is None else [e] if isinstance(e, str)
                   else list(e))
    return out


def _ref_leaves(tree, drop_counters=False):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = []
    for path, leaf in flat:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        if drop_counters and name.endswith((".length", ".position")):
            continue
        shard = leaf.sharding.shard_shape(leaf.shape)
        out.append([name, list(leaf.shape), str(leaf.dtype),
                    _norm(leaf.sharding.spec, len(leaf.shape)),
                    int(np.prod(shard, dtype=np.int64))
                    * leaf.dtype.itemsize])
    return out


def _ref_inputs(arch, mesh_name):
    shape, axes = MESHES[mesh_name]
    mesh = jax.sharding.AbstractMesh(shape, axes)
    cfg = ref_get_config(arch)
    model = RefLM(cfg)
    opt_cfg = RefAdamWConfig()
    out = {"params": _ref_leaves(RS.shaped_params(model, mesh)),
           "opt": _ref_leaves(RS.shaped_opt_state(model, mesh, opt_cfg))}
    for s in RS.SHAPES:
        out[f"batch/{s}"] = _ref_leaves(RS.batch_specs(cfg, mesh, s))
        if RS.SHAPES[s]["kind"] == "decode" and \
                RS.shape_applicable(cfg, s)[0]:
            out[f"decode/{s}"] = _ref_leaves(
                RS.shaped_decode_state(model, cfg, mesh, s),
                drop_counters=True)
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", arch_ids())
def test_shaped_inputs_match_reference(port_inputs, arch, mesh_name):
    port = port_inputs[f"shaped:{arch}:{mesh_name}"]
    ref = _ref_inputs(arch, mesh_name)
    assert sorted(port) == sorted(ref)
    sharded = 0
    for group in ref:
        got, want = port[group], ref[group]
        assert [g[0] for g in got] == [w[0] for w in want], group
        for g, w in zip(got, want):
            path, shape, dtype, spec, nbytes = g
            assert shape == w[1] and dtype == w[2], (group, path, g, w)
            assert _norm(spec, len(shape)) == w[3], (group, path, g, w)
            assert nbytes == w[4], (group, path, g, w)
            sharded += any(w[3])
        assert sum(g[4] for g in got) == sum(w[4] for w in want), group
    assert sharded > 0
