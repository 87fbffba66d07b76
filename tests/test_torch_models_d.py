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

from repro_torch.configs import get_smoke_config
from repro_torch.models import LM, LayerSpec, blocks
from repro_torch.models import attention as attn
from repro_torch.models.common import dense_init
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
    """``LM.init`` draws each repeat straight into its slice of the stack:
    the parameters equal a list of per-repeat draws from the same seed,
    stacked afterwards, leaf for leaf and in dtype."""
    cfg = get_smoke_config(arch)
    got = LM(cfg).init(torch.Generator().manual_seed(4), device="cpu")
    g = torch.Generator().manual_seed(4)
    want = {"embed": dense_init(g, (cfg.padded_vocab, cfg.d_model),
                                cfg.pdtype, scale=cfg.d_model ** -0.5)}
    want["blocks"] = _stack([
        {f"layer{i}": blocks.init_block(g, cfg, spec)
         for i, spec in enumerate(cfg.pattern)}
        for _ in range(cfg.n_repeats)])
    if not cfg.tie_embeddings:
        want["lm_head"] = dense_init(g, (cfg.d_model, cfg.padded_vocab),
                                     cfg.pdtype)
    if cfg.n_encoder_layers:
        want["encoder"] = _stack([
            blocks.init_block(g, cfg, LayerSpec("attn", "dense"))
            for _ in range(cfg.n_encoder_layers)])
        want["cross"] = _stack([
            {f"layer{i}": {"xattn": attn.init_attention(g, cfg)}
             for i in range(len(cfg.pattern))}
            for _ in range(cfg.n_repeats)])

    def check(a, b, path=""):
        if isinstance(b, dict):
            for k in b:
                check(a[k], b[k], f"{path}/{k}")
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path

    check(got, want)
