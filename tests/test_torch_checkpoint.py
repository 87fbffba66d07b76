"""Port parity: checkpoints (``repro_torch.checkpoint.CheckpointManager``)
— the reference's substrate tests mirrored in the port, and checkpoints
carried between the packages.

Every comparison here is exact: a restored leaf equals the saved one bit
for bit (bf16 compared through its raw 16 bits), in either direction
between the packages for fp32 and int32 leaves, and the on-disk layout
(paths, ``meta.json`` fields, ``COMMITTED`` last) is the reference's.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro_torch.checkpoint import CheckpointManager
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.tree import flatten_with_paths


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _assert_trees_bitwise(a, b):
    pa, la = flatten_with_paths(a)
    pb, lb = flatten_with_paths(b)
    assert pa == pb
    for path, x, y in zip(pa, la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=path)


def _mixed_tree(rng):
    """fp32, int32 and bf16 leaves (with -0, NaN and Inf among the bf16
    bits), dict keys out of sorted order, and an AdamW state beside."""
    bf = torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32)).to(
        torch.bfloat16)
    bf[0, 0], bf[0, 1], bf[0, 2] = -0.0, float("nan"), float("inf")
    params = {"w": torch.from_numpy(rng.normal(size=(4, 6)).astype(
                  np.float32)),
              "emb": bf,
              "nested": {"k": torch.arange(7, dtype=torch.int32),
                         "a": torch.tensor(3.5)}}
    return params, adamw_init(params, AdamWConfig())


# ------------------------------- tests/test_substrates.py, in the port ----
def test_checkpoint_roundtrip_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones((5,), dtype=torch.int32)}}
    for step in (1, 2, 3):
        mgr.save(step, {"a": tree["a"] * step,
                        "nested": {"b": tree["nested"]["b"] * step}},
                 extras={"step": step})
    assert mgr.all_steps() == [2, 3]  # retention dropped step 1
    restored, extras = mgr.restore(3, tree)
    np.testing.assert_array_equal(restored["a"].numpy(),
                                  np.arange(12.0).reshape(3, 4) * 3)
    assert restored["nested"]["b"].dtype == torch.int32
    assert extras["step"] == 3


def test_checkpoint_async_and_atomicity(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    w = torch.ones((128, 64))
    mgr.save_async(10, {"w": w}, extras={"loss": 1.5})
    w.mul_(2)                  # the copy was taken before save_async returned
    mgr.wait()
    assert mgr.latest_step() == 10
    # A partial (uncommitted) dir is ignored.
    os.makedirs(tmp_path / "step_00000011")
    os.makedirs(tmp_path / "step_00000012.tmp")
    assert mgr.latest_step() == 10
    restored, extras = mgr.restore(10, {"w": w})
    assert torch.equal(restored["w"], torch.ones((128, 64)))
    assert extras == {"loss": 1.5}


def test_checkpoint_restore_onto_another_device(tmp_path):
    """A ``meta`` target gives the shapes alone; ``sharding_fn`` names the
    device of each leaf (the port's counterpart of the reference's
    restore into a new sharding)."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.arange(16.0).reshape(4, 4),
                 "i": torch.arange(3, dtype=torch.int32)})
    target = {"w": torch.empty((4, 4), device="meta"),
              "i": torch.empty((3,), dtype=torch.int32, device="meta")}
    seen = []

    def place(path):
        seen.append(path)
        return torch.device("cpu")

    restored, _ = mgr.restore(1, target, sharding_fn=place)
    assert sorted(seen) == ["i", "w"]
    assert restored["w"].device.type == "cpu"
    np.testing.assert_array_equal(restored["w"].numpy(),
                                  np.arange(16.0).reshape(4, 4))


def test_meta_target_without_placement_takes_the_card(tmp_path,
                                                      monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgr.restore(1, {"w": torch.empty(2, device="meta")})


# ----------------------------------------------------------- the port's ----
def test_mixed_tree_with_adamw_state_roundtrips_bit_for_bit(tmp_path):
    rng = np.random.default_rng(0)
    params, state = _mixed_tree(rng)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(4, (params, state), extras={"pipeline": {"step": 4,
                                                             "seed": 0}})
    mgr.wait()
    restored, extras = mgr.restore(4, (params, state))
    _assert_trees_bitwise(restored, (params, state))
    assert restored[0]["w"] is not params["w"]
    assert restored[1].step.dtype == torch.int32
    assert extras["pipeline"] == {"step": 4, "seed": 0}


def test_layout_is_the_references(tmp_path):
    rng = np.random.default_rng(1)
    params, state = _mixed_tree(rng)
    CheckpointManager(str(tmp_path)).save(7, (params, state))
    d = tmp_path / "step_00000007"
    assert sorted(os.listdir(d)) == ["COMMITTED", "host_0000.npz",
                                     "meta.json"]
    meta = json.loads((d / "meta.json").read_text())
    assert set(meta) == {"step", "leaves", "extras", "process_index"}
    assert list(meta["leaves"]) == [
        "0/emb", "0/nested/a", "0/nested/k", "0/w", "1/.step",
        "1/.m/emb", "1/.m/nested/a", "1/.m/nested/k", "1/.m/w",
        "1/.v/emb", "1/.v/nested/a", "1/.v/nested/k", "1/.v/w"]
    assert meta["leaves"]["0/emb"]["dtype"] == "bfloat16"
    assert meta["leaves"]["0/nested/k"] == {
        "shape": [7], "dtype": "int32",
        "shards": [{"key": "0/nested/k::0", "index": [[None, None, None]]}]}
    with np.load(d / "host_0000.npz") as f:
        assert f["0/emb::0"].dtype == np.dtype("V2")
        assert f["1/.step::0"].shape == ()


def _ref_tree(rng):
    return {"w": jnp.asarray(rng.normal(size=(4, 6)).astype(np.float32)),
            "nested": {"k": jnp.arange(7, dtype=jnp.int32),
                       "a": jnp.asarray(3.5, jnp.float32)}}


def test_port_restores_a_reference_checkpoint(tmp_path):
    """A reference checkpoint of fp32/int32 leaves (its params and AdamW
    state) restores in the port bit for bit, onto a ``meta`` target."""
    rng = np.random.default_rng(2)
    rp = _ref_tree(rng)
    rs = ref_adamw_init(rp, RefAdamWConfig())
    grads = jax.tree.map(lambda x: x.astype(jnp.float32), rp)
    rp, rs, _ = ref_adamw_update(rp, grads, rs, RefAdamWConfig())
    RefManager(str(tmp_path)).save(3, (rp, rs), extras={"x": 1})
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 3
    meta_p = {"w": torch.empty((4, 6), device="meta"),
              "nested": {"k": torch.empty(7, dtype=torch.int32,
                                          device="meta"),
                         "a": torch.empty((), device="meta")}}
    target = (meta_p, adamw_init(meta_p, AdamWConfig()))
    (params, state), extras = mgr.restore(3, target,
                                          sharding_fn=lambda p: "cpu")
    want = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), (rp, rs))
    _assert_trees_bitwise((params, state), (want[0], type(state)(*want[1])))
    assert extras == {"x": 1}


def test_reference_restores_a_port_checkpoint(tmp_path):
    rng = np.random.default_rng(3)
    params = {"w": torch.from_numpy(rng.normal(size=(4, 6)).astype(
                  np.float32)),
              "nested": {"k": torch.arange(7, dtype=torch.int32),
                         "a": torch.tensor(3.5)}}
    state = adamw_init(params, AdamWConfig())
    CheckpointManager(str(tmp_path)).save(5, (params, state),
                                          extras={"y": [1, 2]})
    rp = _ref_tree(rng)
    ref_mgr = RefManager(str(tmp_path))
    assert ref_mgr.latest_step() == 5
    (got_p, got_s), extras = ref_mgr.restore(
        5, (rp, ref_adamw_init(rp, RefAdamWConfig())))
    np.testing.assert_array_equal(np.asarray(got_p["w"]),
                                  params["w"].numpy())
    np.testing.assert_array_equal(np.asarray(got_p["nested"]["k"]),
                                  np.arange(7))
    assert np.asarray(got_p["nested"]["k"]).dtype == np.int32
    assert int(got_s.step) == 0
    assert extras == {"y": [1, 2]}


def test_port_restores_a_reference_bf16_leaf_bit_for_bit(tmp_path):
    """The reference writes a bf16 leaf as raw 16-bit void data (its own
    restore cannot cast it back); the port reads those bits as bf16."""
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.normal(size=(6, 5)).astype(np.float32)).astype(
        jnp.bfloat16)
    RefManager(str(tmp_path)).save(1, {"e": x})
    restored, _ = CheckpointManager(str(tmp_path)).restore(
        1, {"e": torch.empty((6, 5), dtype=torch.bfloat16)})
    want = np.asarray(x).view(np.int16)
    np.testing.assert_array_equal(_bits(restored["e"]), want)
    with pytest.raises(ValueError):            # the reference's own limit
        RefManager(str(tmp_path)).restore(1, {"e": x})
