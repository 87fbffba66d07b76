"""Port parity, fourth part: the four archs with MoE, Mamba or xLSTM layers
(qwen2-moe-a2.7b, dbrx-132b, jamba-1.5-large-398b, xlstm-125m) as whole
LMs in their smoke configs (fp32, on the CPU), with the reference's
parameters carried across, and ``LM.init``'s stacking of the repeats.

Tolerance: ``forward`` logits and the MoE aux loss within ``LOGIT_TOL``
(atol and rtol 1e-4) of the reference's; the largest difference seen was
1.2e-5 on logits of magnitude 4 (xlstm-125m).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.configs import get_smoke_config
from repro_torch.models import LM, LayerSpec, blocks
from repro_torch.models import attention as attn
from repro_torch.models.common import dense_init, draw_tree
from repro_torch.prng import PRNGKey
from test_torch_models import (LOGIT_TOL, RECURRENT_MOE_ARCHS, lm_inputs,
                               ref_and_port)


@pytest.mark.parametrize("arch", RECURRENT_MOE_ARCHS)
def test_forward_logits_match_reference(arch):
    ref, rp, lm, params = ref_and_port(arch, seed=0)
    tokens, _ = lm_inputs(lm.cfg, np.random.default_rng(0))
    want, want_aux = jax.jit(ref.forward)(rp, jnp.asarray(tokens))
    got, aux = lm.forward(params, torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    assert got.shape == (2, 8, lm.cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    assert (float(aux) > 0) == (lm.cfg.moe is not None)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


@pytest.mark.parametrize("arch", ("qwen2-moe-a2.7b", "whisper-tiny"))
def test_init_draws_repeats_in_order(arch):
    """``LM.init`` draws each repeat under its own key of the reference's
    split tree, as ``jax.vmap`` over keys does: the parameters equal
    per-repeat draws under those keys, stacked afterwards, leaf for leaf
    and in dtype."""
    cfg = get_smoke_config(arch)
    got = LM(cfg).init(PRNGKey(4), device="cpu")
    k_embed, k_head, k_layers, k_enc, k_cross = prng.split(PRNGKey(4), 5)
    want = {"embed": dense_init(k_embed, (cfg.padded_vocab, cfg.d_model),
                                cfg.pdtype, scale=cfg.d_model ** -0.5
                                ).draw("cpu")}
    layer_keys = prng.split(k_layers, cfg.n_repeats)
    want["blocks"] = _stack([
        {f"layer{i}": draw_tree(blocks.init_block(
            prng.split(layer_keys[r], len(cfg.pattern))[i], cfg, spec),
            "cpu")
         for i, spec in enumerate(cfg.pattern)}
        for r in range(cfg.n_repeats)])
    if not cfg.tie_embeddings:
        want["lm_head"] = dense_init(k_head, (cfg.d_model, cfg.padded_vocab),
                                     cfg.pdtype).draw("cpu")
    if cfg.n_encoder_layers:
        enc_keys = prng.split(k_enc, cfg.n_encoder_layers)
        want["encoder"] = _stack([
            draw_tree(blocks.init_block(enc_keys[r], cfg,
                                        LayerSpec("attn", "dense")), "cpu")
            for r in range(cfg.n_encoder_layers)])
        cross_keys = prng.split(k_cross, cfg.n_repeats)
        want["cross"] = _stack([
            {f"layer{i}": {"xattn": draw_tree(attn.init_attention(
                prng.split(cross_keys[r], len(cfg.pattern))[i], cfg), "cpu")}
             for i in range(len(cfg.pattern))}
            for r in range(cfg.n_repeats)])

    def check(a, b, path=""):
        if isinstance(b, dict):
            for k in b:
                check(a[k], b[k], f"{path}/{k}")
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path

    check(got, want)
