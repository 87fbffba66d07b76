"""Port parity: the train step (``repro_torch.launch.steps``:
``make_loss_fn``, ``loss_and_grads``, ``make_train_step``) against the
reference's ``repro.launch.steps`` on weights carried across by
``lm_params_from_arrays`` and the same numpy batch (B 4, S 16; frames or
patch embeddings for whisper and pixtral), fp32 smoke configs.

One arch of each family, one or two a file (the reference's jitted step
costs 5–30 s an arch on this CPU): smollm-360m here (with ``n_micro=2``
against the reference's own ``make_train_step(n_micro=2)``), whisper-tiny
(frames) and pixtral-12b (patch embeddings) in ``_b``, qwen2-moe-a2.7b in
``_moe``, jamba-1.5-large-398b in ``_jamba``, xlstm-125m in ``_xlstm``.

The reference side is its ``make_loss_fn`` (``loss_chunk`` 8 < S, so
the loss runs over two chunks) under ``jax.value_and_grad`` followed by
its ``adamw_update`` — the body of its ``make_train_step`` — in one jit.
The port side is ``loss_and_grads`` of its ``make_loss_fn`` (same chunk)
and its ``make_train_step`` (default chunk: one chunk of 16).

Tolerances (``check_parity``; the largest difference seen over the six
archs in brackets):
* the total loss and the NLL: atol 1e-5 (4.8e-7);
* every gradient leaf: atol 2e-5 (3.8e-6, xlstm-125m, gradients up to
  0.67);
* the grad norm: rtol 1e-5 (5.7e-7);
* the updated parameters: atol 1e-6 where the reference's gradient is at
  least 1e-5 in size (1.5e-7), and 2·lr everywhere (6.6e-5, smollm-360m,
  at |g| = 1.9e-9).  At AdamW's first step the update is
  lr·g/(|g|+eps): where |g| is near eps = 1e-8 the packages' rounding of
  g is amplified up to lr, and the update can never exceed lr;
* the moments: m atol 2e-6, a tenth of the gradients' (2.8e-8); v atol
  1e-8 (6.5e-10).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as RO
from repro.configs import arch_ids
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.launch import steps as RS
from repro.models import LM as RefLM
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.interop import lm_params_from_arrays
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import LM
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.tree import flatten_with_paths

LOSS_ATOL = 1e-5
GRAD_ATOL = 2e-5
PARAM_ATOL = 1e-6
WELL_CONDITIONED = 1e-5
M_ATOL, V_ATOL = 2e-6, 1e-8
B, SEQ, CHUNK = 4, 16, 8


def inputs(cfg, seed=1):
    """Numpy batch: tokens, labels and the frontend stub's embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, SEQ)).astype(
               np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, SEQ)).astype(
               np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.normal(
            size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def both(arch, seed=1):
    """(ref LM, ref params, port LM, port params, numpy batch)."""
    rcfg, cfg = ref_get_smoke_config(arch), get_smoke_config(arch)
    ref = RefLM(rcfg)
    rp = jax.jit(ref.init)(jax.random.PRNGKey(seed))
    params = lm_params_from_arrays(cfg, jax.tree.map(np.asarray, rp),
                                   device="cpu")
    return ref, rp, LM(cfg), params, inputs(cfg, seed)


def _leaves(tree):
    return flatten_with_paths(jax.tree.map(
        lambda x: np.asarray(x, np.float32) if hasattr(x, "dtype")
        else x, tree))


def assert_update_close(ref_params, ref_grads, port_params, lr):
    paths, want = _leaves(ref_params)
    _, grads = _leaves(ref_grads)
    got_paths, got = flatten_with_paths(port_params)
    assert paths == got_paths
    for path, w, g, t in zip(paths, want, grads, got):
        t = t.to(torch.float32).numpy()
        err = np.abs(t - w)
        well = np.abs(g) >= WELL_CONDITIONED
        assert err[well].max(initial=0) <= PARAM_ATOL, path
        assert err.max(initial=0) <= 2 * lr, path


def assert_tree_close(ref_tree, port_tree, atol):
    paths, want = _leaves(ref_tree)
    got_paths, got = flatten_with_paths(port_tree)
    assert paths == got_paths
    for path, w, t in zip(paths, want, got):
        np.testing.assert_allclose(t.to(torch.float32).numpy(), w, rtol=0,
                                   atol=atol, err_msg=path)


def check_parity(arch, seed=1):
    """The reference's loss, grads and AdamW step against the port's."""
    ref, rp, lm, params, batch = both(arch, seed)
    rcfg, cfg = ref.cfg, lm.cfg
    ropt = RO.AdamWConfig()
    ref_loss = RS.make_loss_fn(ref, rcfg, loss_chunk=CHUNK)

    @jax.jit
    def ref_step(p, b):
        (tot, nll), g = jax.value_and_grad(ref_loss, has_aux=True)(p, b)
        p2, s2, m = RO.adamw_update(p, g, RO.adamw_init(p, ropt), ropt)
        return tot, nll, g, p2, s2, m

    rtot, rnll, rg, rp2, rs2, rm = ref_step(
        rp, jax.tree.map(jnp.asarray, batch))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tot, nll, grads = S.loss_and_grads(
        S.make_loss_fn(lm, cfg, loss_chunk=CHUNK), params, tb)
    assert abs(float(tot) - float(rtot)) <= LOSS_ATOL
    assert abs(float(nll) - float(rnll)) <= LOSS_ATOL
    assert_tree_close(rg, grads, GRAD_ATOL)
    opt_cfg = AdamWConfig()
    embed0 = params["embed"].clone()
    p2, s2, m = S.make_train_step(lm, cfg, opt_cfg)(
        params, adamw_init(params, opt_cfg), tb)
    assert abs(float(m["loss"]) - float(rnll)) <= LOSS_ATOL
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(rm["grad_norm"]), rtol=1e-5)
    assert int(s2.step) == 1
    assert_update_close(rp2, rg, p2, opt_cfg.lr)
    assert_tree_close(rs2.m, s2.m, M_ATOL)
    assert_tree_close(rs2.v, s2.v, V_ATOL)
    # The step returned new trees and left its inputs as they were.
    assert torch.equal(params["embed"], embed0)
    assert not torch.equal(p2["embed"], embed0)


def test_train_step_matches_reference_smollm():
    check_parity("smollm-360m")


def test_train_step_with_microbatches_matches_reference():
    """``n_micro=2``: the reference's own ``make_train_step`` against the
    port's — fp32 grads accumulated over two microbatches of 2."""
    ref, rp, lm, params, batch = both("smollm-360m", seed=4)
    ropt, opt_cfg = RO.AdamWConfig(), AdamWConfig()
    rstep = jax.jit(RS.make_train_step(ref, ref.cfg, ropt, n_micro=2))
    rp2, rs2, rm = rstep(rp, RO.adamw_init(rp, ropt),
                         jax.tree.map(jnp.asarray, batch))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    p2, s2, m = S.make_train_step(lm, lm.cfg, opt_cfg, n_micro=2)(
        params, adamw_init(params, opt_cfg), tb)
    assert abs(float(m["loss"]) - float(rm["loss"])) <= LOSS_ATOL
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(rm["grad_norm"]), rtol=1e-5)
    # The microbatch mean of the two halves' losses and grads.
    halves = [S.loss_and_grads(S.make_loss_fn(lm, lm.cfg), params,
                               {k: v[i * 2:(i + 1) * 2]
                                for k, v in tb.items()}) for i in (0, 1)]
    mean_nll = (torch.zeros(()) + halves[0][1] + halves[1][1]) / 2
    assert torch.equal(m["loss"], mean_nll)
    rg = jax.tree.map(lambda a, b: (a + b) / 2,
                      *(jax.tree.map(lambda x: np.asarray(x.to(
                          torch.float32)), h[2]) for h in halves))
    assert_update_close(rp2, rg, p2, opt_cfg.lr)
    assert_tree_close(rs2.v, s2.v, V_ATOL)


def test_loss_chunk_must_divide_the_sequence():
    _, _, lm, params, batch = both("smollm-360m")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with pytest.raises(ValueError, match="multiple of the loss chunk"):
        S.make_loss_fn(lm, lm.cfg, loss_chunk=6)(params, tb)
    with torch.no_grad():
        tot, nll = S.make_loss_fn(lm, lm.cfg, loss_chunk=4)(params, tb)
        tot2, nll2 = S.make_loss_fn(lm, lm.cfg, loss_chunk=16)(params, tb)
    assert abs(float(nll) - float(nll2)) <= LOSS_ATOL


def test_prefill_and_decode_steps_are_the_models():
    _, _, lm, params, batch = both("smollm-360m")
    tokens = torch.from_numpy(batch["tokens"])
    with torch.no_grad():
        last = S.make_prefill_step(lm, lm.cfg)(params, {"tokens": tokens})
        logits, _ = lm.forward(params, tokens)
        assert torch.equal(last, logits[:, -1])
        state = lm.init_decode_state(params, B, max_len=2)
        got, _ = S.make_decode_step(lm, lm.cfg)(params, state, tokens[:, 0])
        want, _ = lm.decode_step(params, lm.init_decode_state(
            params, B, max_len=2), tokens[:, 0])
    assert torch.equal(got, want)


def test_shapes_and_micro_counts_match_reference():
    assert S.SHAPES == RS.SHAPES
    for arch in arch_ids():
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        for shape in S.SHAPES:
            assert S.shape_applicable(cfg, shape) == RS.shape_applicable(
                rcfg, shape)
        for dims, axes in (((16, 16), ("data", "model")),
                           ((2, 16, 16), ("pod", "data", "model"))):
            mesh = make_serving_mesh(dims, axes, device="cpu")
            ref_mesh = types.SimpleNamespace(axis_names=axes,
                                             shape=dict(zip(axes, dims)))
            for batch in (1, 32, 256):
                assert S.pick_n_micro(cfg, mesh, batch) == RS.pick_n_micro(
                    rcfg, ref_mesh, batch)
