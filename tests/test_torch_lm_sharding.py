"""Port parity: the LM's sharding specs (``param_pspec``,
``param_shardings``, ``batch_pspec``, ``cache_pspec`` and ``FSDP`` of
``repro_torch.launch.sharding``) against the reference's, for every
parameter leaf of all ten **full** configs — the port's ``device="meta"``
tree against the reference's ``jax.eval_shape`` tree, paths and shapes
equal — on stand-ins of the production meshes (16, 16) and (2, 16, 16).

The reference's rules read only a mesh's ``axis_names`` and ``shape``, so
it runs on a stand-in object; the port runs on its own virtual ``Mesh``
(256 or 512 positions on the CPU).  Every spec must be equal (jax's
``PartitionSpec`` equality, which takes a single axis and a one-axis
tuple as the same).
"""
import types

import jax
import pytest
import torch

from repro.configs import arch_ids as ref_arch_ids
from repro.configs import get_config as ref_get_config
from repro.launch import sharding as RS
from repro.models import LM as RefLM
from repro_torch.configs import get_config
from repro_torch.launch import sharding as TS
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.launch.steps import params_shape
from repro_torch.models import LM
from repro_torch.prng import PRNGKey
from repro_torch.tree import flatten_with_paths

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    shape, axes = MESHES[name]
    port = make_serving_mesh(shape, axes, device="cpu")
    ref = types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))
    return port, ref


def _ref_paths(cfg):
    shapes = jax.eval_shape(lambda: RefLM(cfg).init(jax.random.PRNGKey(0)))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path) for path, _ in flat], \
        [leaf.shape for _, leaf in flat]


@pytest.mark.parametrize("arch", ref_arch_ids())
def test_param_pspec_matches_reference_on_every_leaf(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    meta = params_shape(LM(cfg))
    paths, leaves = flatten_with_paths(meta)
    ref_paths, ref_shapes = _ref_paths(rcfg)
    assert paths == ref_paths
    assert [tuple(t.shape) for t in leaves] == [tuple(s) for s in ref_shapes]
    assert all(t.device.type == "meta" for t in leaves)
    for name in MESHES:
        port_mesh, ref_mesh = _meshes(name)
        specs = flatten_with_paths(TS.param_shardings(meta, port_mesh,
                                                      cfg))[1]
        sharded = 0
        for path, t, spec in zip(paths, leaves, specs):
            want = RS.param_pspec(path, tuple(t.shape), ref_mesh, rcfg)
            assert isinstance(spec, TS.PartitionSpec)
            assert want == spec, (name, path, want, spec)
            assert spec == TS.param_pspec(path, tuple(t.shape), port_mesh,
                                          cfg)
            sharded += any(a is not None for a in spec)
        assert sharded > 0, name


@pytest.mark.parametrize("name", list(MESHES))
def test_batch_and_cache_pspecs_match_reference(name):
    port_mesh, ref_mesh = _meshes(name)
    assert RS.batch_pspec(ref_mesh) == TS.batch_pspec(port_mesh)
    assert TS.FSDP == RS.FSDP
    for arch in ref_arch_ids():
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        for batch in (1, 7, 16, 32, 128, 256):
            got = TS.cache_pspec(port_mesh, cfg, batch)
            want = RS.cache_pspec(ref_mesh, rcfg, batch)
            assert set(got) == set(want)
            for k in want:
                assert want[k] == got[k], (arch, batch, k)


def test_param_shardings_keeps_the_tree():
    cfg = get_config("smollm-360m")
    port_mesh, _ = _meshes("16x16")
    meta = LM(cfg).init(PRNGKey(0), device="meta")
    specs = TS.param_shardings(meta, port_mesh, cfg)
    assert list(specs) == list(meta)
    assert list(specs["blocks"]["layer0"]["attn"]) == ["wq", "wk", "wv",
                                                      "wo"]
    # 15 heads × 64 on the 16-way model axis: wq's columns (960) divide,
    # and the stacked leaves keep their repeat dim whole.
    assert specs["blocks"]["layer0"]["attn"]["wq"] == (None, None, "model")
    assert specs["embed"] == ("model", None)
