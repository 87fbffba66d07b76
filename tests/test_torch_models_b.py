"""Port parity, second part: decode with KV caches
(``repro_torch.models.lm``, ``attention_decode``) against the port's own
forward and the reference's decode chain, in the smoke configs (fp32, on
the CPU).

Tolerance: ``decode_step`` chains within atol and rtol 1e-4 of the port's
``forward`` and of the reference's ``decode_step`` chain (the packages
agree to about 3e-6; the reference's own test allows 2e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models.attention import KVCache
from test_torch_models import ATTN_ARCHS, lm_inputs, ref_and_port

DECODE_TOL = 1e-4


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_decode_matches_forward_and_reference(arch):
    check_decode(arch)


def check_decode(arch):
    """Prefix decode (token by token with caches and states) == the full
    forward, and == the reference's decode chain on the same parameters."""
    ref, rp, lm, params = ref_and_port(arch, seed=2)
    batch, seq = 2, 8
    tokens, kwargs = lm_inputs(lm.cfg, np.random.default_rng(2), batch, seq)
    if lm.cfg.family == "vlm":
        kwargs = {}          # decode does not stream patches: text only
    tk = {k: torch.from_numpy(v) for k, v in kwargs.items()}
    full, _ = lm.forward(params, torch.from_numpy(tokens), **tk)

    state = lm.init_decode_state(params, batch, max_len=seq,
                                 frames=tk.get("frames"))
    ref_state = jax.jit(ref.init_decode_state,
                        static_argnames=("batch", "max_len"))(
        rp, batch=batch, max_len=seq,
        frames=None if "frames" not in kwargs
        else jnp.asarray(kwargs["frames"]))
    ref_step = jax.jit(ref.decode_step)
    outs, ref_outs = [], []
    for t in range(seq):
        logits, state = lm.decode_step(params, state,
                                       torch.from_numpy(tokens[:, t]))
        outs.append(logits)
        ref_logits, ref_state = ref_step(rp, ref_state,
                                         jnp.asarray(tokens[:, t]))
        ref_outs.append(np.asarray(ref_logits))
    assert state.position == seq
    assert all(c.length == seq for c in state.layer_states
               if isinstance(c, KVCache))
    dec = torch.stack(outs, 1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=DECODE_TOL,
                               atol=DECODE_TOL)
    np.testing.assert_allclose(dec.numpy(), np.stack(ref_outs, 1),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


def test_decode_state_layout():
    """Caches stacked over repeats, a Python-int length, written in place."""
    _, _, lm, params = ref_and_port("smollm-360m", seed=0)
    cfg = lm.cfg
    state = lm.init_decode_state(params, 3, max_len=5)
    (cache,) = state.layer_states
    assert cache.k.shape == (cfg.n_repeats, 3, 5, cfg.n_kv_heads, cfg.hd)
    assert cache.length == 0 and state.position == 0
    _, state2 = lm.decode_step(params, state,
                               torch.tensor([1, 2, 3], dtype=torch.int32))
    assert state2.layer_states[0].length == 1 and state2.position == 1
    assert state2.layer_states[0].k is cache.k
    assert float(cache.k[:, :, 0].abs().sum()) > 0
    assert float(cache.k[:, :, 1:].abs().sum()) == 0
