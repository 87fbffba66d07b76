"""Port parity: the optimizer substrate (``repro_torch.optim``: AdamW, the
schedules, int8 gradient compression) against the reference's
``repro.optim``, on the same numpy inputs, and the reference's own
substrate tests (``tests/test_substrates.py``) mirrored in the port.

Tolerances:
* AdamW over several steps (fp32 and bf16 leaves, the clip branch,
  ``state_dtype="bfloat16"``): parameters and moments within 1e-6 of the
  reference's (parameters 3.0e-8 seen, moments equal), bf16 parameters
  within one bf16 ulp of the magnitude (``_BF16_ATOL``; equal seen), the
  grad norm to rtol 1e-6 (6.1e-8 seen: the two packages sum each leaf's
  squares in their own order).
* The schedules: rtol 1e-6 (1.6e-7 seen: fp32 ``cos`` rounds
  differently in the two packages).
* Compression: the int8 payload and the fp32 scales equal bit for bit,
  the residuals and decompressed values within 1e-7 (equal seen).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as R
from repro_torch.interop import adamw_state_from_arrays
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               compress, compress_tree, constant,
                               decompress, global_norm, warmup_cosine,
                               warmup_linear)
from repro_torch.tree import flatten_with_paths

_BF16_ATOL = 2 ** -7


def _tree(rng, scale=1.0):
    """A tree whose dict keys are not in sorted order (the reference walks
    them sorted), with fp32 and bf16 leaves."""
    return {"w": (rng.normal(size=(4, 8)) * scale).astype(np.float32),
            "b": {"z": (rng.normal(size=(16,)) * scale).astype(np.float32),
                  "a": (rng.normal(size=(3, 5)) * scale).astype(np.float32)}}


_BF16 = ("b/a",)


def _port(tree):
    def conv(path, x):
        t = torch.from_numpy(np.array(x, np.float32))
        return t.to(torch.bfloat16) if path in _BF16 else t
    return {"w": conv("w", tree["w"]),
            "b": {"z": conv("b/z", tree["b"]["z"]),
                  "a": conv("b/a", tree["b"]["a"])}}


def _ref(tree):
    def conv(path, x):
        a = jnp.asarray(np.array(x, np.float32))
        return a.astype(jnp.bfloat16) if path in _BF16 else a
    return {"w": conv("w", tree["w"]),
            "b": {"z": conv("b/z", tree["b"]["z"]),
                  "a": conv("b/a", tree["b"]["a"])}}


def _assert_tree_close(ref_tree, port_tree, atol):
    rpaths, rleaves = flatten_with_paths(jax.tree.map(
        lambda x: np.asarray(x, np.float32), ref_tree))
    paths, leaves = flatten_with_paths(port_tree)
    assert rpaths == paths
    for path, a, b in zip(paths, rleaves, leaves):
        tol = _BF16_ATOL * max(1.0, float(np.abs(a).max())) \
            if b.dtype == torch.bfloat16 else atol
        np.testing.assert_allclose(b.to(torch.float32).numpy(), a, rtol=0,
                                   atol=tol, err_msg=path)


@pytest.mark.parametrize("state_dtype,clip", [(None, 1.0), (None, 1e3),
                                              ("bfloat16", 1.0)],
                         ids=["fp32-clipped", "fp32-unclipped", "bf16-state"])
def test_adamw_matches_reference(state_dtype, clip):
    """Five steps under a warmup-cosine schedule; grads of norm ~9 so a
    clip_norm of 1 clips every step and 1e3 none."""
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    rcfg = R.AdamWConfig(lr=0.05, clip_norm=clip, state_dtype=state_dtype)
    cfg = AdamWConfig(lr=0.05, clip_norm=clip, state_dtype=state_dtype)
    rp, tp = _ref(p0), _port(p0)
    rs, ts = R.adamw_init(rp, rcfg), adamw_init(tp, cfg)
    for i in range(5):
        g = _tree(rng, scale=2.0)
        rp, rs, rm = R.adamw_update(rp, _ref(g), rs, rcfg,
                                    R.warmup_cosine(i, 2, 10))
        tp, ts, tm = adamw_update(tp, _port(g), ts, cfg,
                                  warmup_cosine(i, 2, 10))
        assert (float(tm["grad_norm"]) > clip) == (clip == 1.0)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(rm["lr"]),
                                   rtol=1e-6)
        assert int(ts.step) == int(rs.step) == i + 1
        assert ts.step.dtype == torch.int32
        _assert_tree_close(rp, tp, 1e-6)
        _assert_tree_close(rs.m, ts.m, 1e-6)
        _assert_tree_close(rs.v, ts.v, 1e-6)
    want = torch.bfloat16 if state_dtype else torch.float32
    assert ts.m["w"].dtype == want and ts.v["b"]["a"].dtype == want
    assert tp["b"]["a"].dtype == torch.bfloat16


def test_adamw_state_carried_from_the_reference():
    """A reference AdamWState after two steps, carried across by
    ``adamw_state_from_arrays`` with the parameters, takes a third step
    in the port equal to the reference's third."""
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import LM as RefLM
    from repro_torch.configs import get_smoke_config
    from repro_torch.interop import lm_params_from_arrays
    cfg, rcfg = get_smoke_config("smollm-360m"), ref_smoke("smollm-360m")
    rp = jax.jit(RefLM(rcfg).init)(jax.random.PRNGKey(0))
    ocfg, rocfg = AdamWConfig(lr=1e-2), R.AdamWConfig(lr=1e-2)
    rs = R.adamw_init(rp, rocfg)
    ref_update = jax.jit(R.adamw_update, static_argnums=(3,))
    rng = np.random.default_rng(1)

    def grads():
        return jax.tree.map(lambda x: jnp.asarray(rng.normal(
            size=x.shape).astype(np.float32)), rp)

    for _ in range(2):
        rp, rs, _ = ref_update(rp, grads(), rs, rocfg)
    state = adamw_state_from_arrays(cfg, jax.tree.map(np.asarray, rs),
                                    device="cpu")
    params = lm_params_from_arrays(cfg, jax.tree.map(np.asarray, rp),
                                   device="cpu")
    assert int(state.step) == 2 and state.m["embed"].dtype == torch.float32
    g = grads()
    tg = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), g)
    rp, rs, _ = ref_update(rp, g, rs, rocfg)
    params, state, _ = adamw_update(params, tg, state, ocfg)
    _assert_tree_close(rp, params, 1e-6)
    _assert_tree_close(rs.v, state.v, 1e-6)


def test_global_norm_sums_in_reference_leaf_order():
    rng = np.random.default_rng(2)
    t = _tree(rng, scale=3.0)
    np.testing.assert_allclose(float(global_norm(_port(t))),
                               float(R.global_norm(_ref(t))), rtol=1e-6)


@pytest.mark.parametrize("fn", ["warmup_cosine", "warmup_linear",
                                "constant"])
def test_schedules_match_reference(fn):
    for step in range(0, 25):
        for warm, total in ((0, 10), (3, 10), (5, 20), (10, 10)):
            if fn == "constant":
                got, want = constant(step, warm), R.constant(step, warm)
            else:
                got = globals()[fn](step, warm, total)
                want = getattr(R, fn)(step, warm, total)
            assert got.dtype == torch.float32 and got.shape == ()
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                       err_msg=f"{fn}({step}, {warm})")


@pytest.mark.parametrize("n", [1, 255, 256, 1000, 4097])
def test_compress_matches_reference(n):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(n,)) * rng.choice([1e-3, 1.0, 50.0], n)
         ).astype(np.float32)
    x[::7] = 0.0
    c, res = compress(torch.from_numpy(x))
    rc, rres = R.compress(jnp.asarray(x))
    assert c.q.dtype == torch.int8
    np.testing.assert_array_equal(c.q.numpy(), np.asarray(rc.q))
    np.testing.assert_array_equal(c.scale.numpy(), np.asarray(rc.scale))
    np.testing.assert_allclose(res.numpy(), np.asarray(rres), atol=1e-7)
    np.testing.assert_allclose(decompress(c).numpy(),
                               np.asarray(R.decompress(rc)), atol=1e-7)


def test_compress_rounds_half_to_even():
    """A block whose scale is 1 (max |x| = 127) quantizes x.5 to the even
    integer, as ``jnp.round`` does."""
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5] + [0.0] * 250,
                 np.float32)
    c, _ = compress(torch.from_numpy(x))
    rc, _ = R.compress(jnp.asarray(x))
    assert c.q[0, :6].tolist() == [127, 0, 2, 2, 0, -2]
    np.testing.assert_array_equal(c.q.numpy(), np.asarray(rc.q))


def test_compress_tree_matches_reference():
    rng = np.random.default_rng(3)
    res = rres = None
    for _ in range(4):
        g = {"w": rng.normal(size=(64,)).astype(np.float32),
             "a": {"b": rng.normal(size=(7, 9)).astype(np.float32)}}
        ghat, res = compress_tree(
            {"w": torch.from_numpy(g["w"]),
             "a": {"b": torch.from_numpy(g["a"]["b"])}}, res)
        rghat, rres = R.compress_tree(jax.tree.map(jnp.asarray, g), rres)
        _assert_tree_close(rghat, ghat, 1e-7)
        _assert_tree_close(rres, res, 1e-7)


# ------------------------------- tests/test_substrates.py, in the port ----
def test_adamw_converges_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, clip_norm=10.0)
    params = {"w": torch.tensor([5.0, -3.0]), "b": torch.tensor([2.0])}
    state = adamw_init(params, cfg)

    def loss(p):
        return torch.sum(p["w"] ** 2) + torch.sum(p["b"] ** 2)

    for i in range(200):
        g = {k: 2 * v for k, v in params.items()}
        params, state, metrics = adamw_update(params, g, state, cfg,
                                              warmup_cosine(i, 10, 200))
    assert float(loss(params)) < 1e-2
    assert np.isfinite(float(metrics["grad_norm"]))


def test_adamw_bf16_state_dtype():
    cfg = AdamWConfig(lr=0.1, state_dtype="bfloat16")
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    state = adamw_init(params, cfg)
    assert state.m["w"].dtype == torch.bfloat16
    g = {"w": torch.full((4, 4), 0.5, dtype=torch.bfloat16)}
    p2, s2, _ = adamw_update(params, g, state, cfg)
    assert p2["w"].dtype == torch.bfloat16
    assert float((p2["w"] - params["w"]).abs().max()) > 0
    assert torch.equal(params["w"], torch.ones((4, 4), dtype=torch.bfloat16))


def test_compress_roundtrip_accuracy():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1000,)).astype(np.float32))
    c, residual = compress(x)
    xh = decompress(c)
    assert c.q.dtype == torch.int8
    assert float((xh - x).abs().max()) < 0.05
    np.testing.assert_allclose((x - xh).numpy(), residual.numpy(),
                               atol=1e-6)


def test_error_feedback_preserves_mean_update():
    rng = np.random.default_rng(1)
    true_sum = np.zeros((64,), np.float32)
    comp_sum = np.zeros((64,), np.float32)
    res = None
    for _ in range(50):
        g = {"w": torch.from_numpy(rng.normal(size=(64,)).astype(
            np.float32))}
        true_sum += g["w"].numpy()
        ghat, res = compress_tree(g, res)
        comp_sum += ghat["w"].numpy()
    np.testing.assert_allclose(comp_sum, true_sum, atol=0.1)
