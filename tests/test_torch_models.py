"""Port parity: the LM scaffold's configs and forward pass
(``repro_torch.configs``, ``repro_torch.models``) against the reference's.

The six attention-family archs run in their smoke configs (fp32 on the
CPU), with the reference's parameters carried across by
``repro_torch.interop.lm_params_from_arrays``; the four archs with MoE,
Mamba or xLSTM layers (``RECURRENT_MOE_ARCHS``) run in
``test_torch_models_d.py``.  Full configs of all ten archs are compared
as data (every field, ``n_params``, ``active_params``) and as parameter
trees on ``meta`` against the reference's ``jax.eval_shape``, shapes and
dtypes — nothing full-width is built here.

Tolerance: ``forward`` logits within ``LOGIT_TOL`` (atol and rtol 1e-4)
of the reference's; the two packages agree to about 3e-6 on logits of
magnitude 4 (XLA and torch round the fp32 matmuls differently).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import arch_ids as ref_arch_ids
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import LM as RefLM
from repro_torch.configs import arch_ids, get_config, get_smoke_config
from repro_torch.interop import lm_params_from_arrays
from repro_torch.models import LM

LOGIT_TOL = 1e-4
ATTN_ARCHS = ("whisper-tiny", "smollm-360m", "minitron-4b", "llama3.2-1b",
              "gemma-7b", "pixtral-12b")
RECURRENT_MOE_ARCHS = ("qwen2-moe-a2.7b", "dbrx-132b",
                       "jamba-1.5-large-398b", "xlstm-125m")


def ref_and_port(arch, seed):
    """(reference LM, its params, port LM, the same params in the port)."""
    rcfg, cfg = ref_get_smoke_config(arch), get_smoke_config(arch)
    ref = RefLM(rcfg)
    rp = jax.jit(ref.init)(jax.random.PRNGKey(seed))
    params = lm_params_from_arrays(cfg, jax.tree.map(np.asarray, rp),
                                   device="cpu")
    return ref, rp, LM(cfg), params


def lm_inputs(cfg, rng, batch=2, seq=8):
    """Tokens and the frontend stub's embeddings, as numpy."""
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    kwargs = {}
    if cfg.family == "encdec":
        kwargs["frames"] = rng.normal(
            size=(batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        kwargs["patch_embeds"] = rng.normal(
            size=(batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return tokens, kwargs


def _as_dict(cfg):
    return dataclasses.asdict(cfg)


def test_registry_matches_reference():
    assert arch_ids() == ref_arch_ids()
    for arch in arch_ids():
        for get, ref_get in ((get_config, ref_get_config),
                             (get_smoke_config, ref_get_smoke_config)):
            cfg, rcfg = get(arch), ref_get(arch)
            assert _as_dict(cfg) == _as_dict(rcfg), arch
            assert (cfg.hd, cfg.n_layers, cfg.padded_vocab) == (
                rcfg.hd, rcfg.n_layers, rcfg.padded_vocab)
            assert cfg.pdtype == getattr(torch, cfg.param_dtype)
            assert cfg.cdtype == getattr(torch, cfg.compute_dtype)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")


@pytest.mark.parametrize("arch", ref_arch_ids())
def test_param_counts_match_reference(arch):
    for get, ref_get in ((get_config, ref_get_config),
                         (get_smoke_config, ref_get_smoke_config)):
        cfg, rcfg = get(arch), ref_get(arch)
        assert cfg.n_params() == rcfg.n_params()
        assert cfg.active_params() == rcfg.active_params()


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def _dtypes(tree):
    """Each leaf's dtype by name ("float32", "bfloat16", ...)."""
    if isinstance(tree, dict):
        return {k: _dtypes(v) for k, v in tree.items()}
    return str(tree.dtype).removeprefix("torch.")


#: Leaves both packages keep in fp32 whatever the config's dtype.
FP32_LEAVES = {"router", "A_log", "D"}


@pytest.mark.parametrize("arch", ref_arch_ids())
def test_full_param_tree_on_meta_matches_eval_shape(arch):
    """The full-width tree, shapes and dtypes only: no array is
    allocated."""
    cfg = get_config(arch)
    params = LM(cfg).init(torch.Generator(), device="meta")
    want = jax.eval_shape(RefLM(ref_get_config(arch)).init,
                          jax.random.PRNGKey(0))
    assert _shapes(params) == _shapes(want)
    assert _dtypes(params) == _dtypes(want)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    for path, t in leaves:
        assert t.device.type == "meta"
        assert t.dtype == (torch.float32 if path[-1].key in FP32_LEAVES
                           else cfg.pdtype), path
    leaves = [t for _, t in leaves]
    n = sum(t.numel() for t in leaves)
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(want))
    if arch == "smollm-360m":
        assert cfg.pdtype == torch.bfloat16
        assert params["blocks"]["layer0"]["attn"]["wk"].shape == (32, 960,
                                                                  320)
        assert params["embed"].shape == (49152, 960)


def test_lm_params_from_arrays_checks_the_tree():
    cfg = get_smoke_config("smollm-360m")
    ref = RefLM(ref_get_smoke_config("smollm-360m"))
    tree = jax.tree.map(np.asarray, jax.jit(ref.init)(jax.random.PRNGKey(0)))
    params = lm_params_from_arrays(cfg, tree, device="cpu")
    np.testing.assert_array_equal(
        params["blocks"]["layer0"]["mlp"]["wi"].numpy(),
        tree["blocks"]["layer0"]["mlp"]["wi"])
    bad = dict(tree, lm_head=tree["embed"].T)
    with pytest.raises(ValueError, match="keys"):
        lm_params_from_arrays(cfg, bad, device="cpu")
    bad = dict(tree, embed=tree["embed"][:-1])
    with pytest.raises(ValueError, match="embed: shape"):
        lm_params_from_arrays(cfg, bad, device="cpu")
    # bf16 leaves land exactly in a bf16 config.
    full = dataclasses.replace(cfg, param_dtype="bfloat16")
    bf = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                      tree)
    got = lm_params_from_arrays(full, bf, device="cpu")
    assert got["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["embed"].float().numpy(),
                                  bf["embed"].astype(np.float32))


def test_init_is_seeded_and_shaped():
    cfg = get_smoke_config("whisper-tiny")
    a = LM(cfg).init(torch.Generator().manual_seed(3), device="cpu")
    b = LM(cfg).init(torch.Generator().manual_seed(3), device="cpu")
    want = jax.eval_shape(RefLM(ref_get_smoke_config("whisper-tiny")).init,
                          jax.random.PRNGKey(0))
    assert _shapes(a) == _shapes(want)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert torch.equal(x, y)
    emb = a["embed"]
    # Truncated normal at ±2σ, scaled by d^-1/2.
    assert float(emb.abs().max()) <= 2.0 * cfg.d_model ** -0.5 + 1e-6
    assert float(a["blocks"]["layer0"]["norm1"].abs().max()) == 0.0


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_forward_logits_match_reference(arch):
    ref, rp, lm, params = ref_and_port(arch, seed=0)
    tokens, kwargs = lm_inputs(lm.cfg, np.random.default_rng(0))
    want, want_aux = jax.jit(ref.forward)(
        rp, jnp.asarray(tokens), **{k: jnp.asarray(v)
                                    for k, v in kwargs.items()})
    got, aux = lm.forward(params, torch.from_numpy(tokens),
                          **{k: torch.from_numpy(v)
                             for k, v in kwargs.items()})
    assert got.dtype == torch.float32
    assert got.shape == (2, 8, lm.cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert float(aux) == float(want_aux) == 0.0
    hidden, _ = lm.forward_hidden(params, torch.from_numpy(tokens),
                                  **{k: torch.from_numpy(v)
                                     for k, v in kwargs.items()})
    assert torch.equal(lm.unembed(params, hidden), got)
