"""Port parity: the Mamba block (``repro_torch.models.mamba``) against the
reference's ``repro.models.mamba`` on the same numpy inputs, on the CPU.

Parameters come from the reference's ``init_mamba`` at jamba's smoke
width (d_model 64, d_inner 128, d_state 4), with ``dt_bias`` and ``D``
drawn at random so every term of the recurrence counts; activations from
a seeded numpy generator.  The chunked forward runs over several chunks
(S=16 in chunks of 4), at an S whose largest divisor under the chunk is
not the chunk (S=12, chunk 8 → chunks of 6), at a prime S (one chunk of
7) and at the default chunk.

Tolerance: ``MAMBA_TOL`` (atol and rtol 1e-4) on outputs, the decode
step's output and its new SSM state (the conv window is a copy: exact).
The doubling scan and XLA's associative scan add the same terms in
different trees; the largest difference seen was 2.2e-7 on outputs of
magnitude 0.9 (fp32).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.mamba as RMB
import repro_torch.models.mamba as TMB
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro_torch.configs import get_smoke_config

MAMBA_TOL = 1e-4
ARCH = "jamba-1.5-large-398b"


def _setup(seed):
    rcfg, cfg = ref_get_smoke_config(ARCH), get_smoke_config(ARCH)
    p = jax.tree.map(np.array, RMB.init_mamba(jax.random.PRNGKey(seed),
                                              rcfg))
    rng = np.random.default_rng(seed)
    p["dt_bias"] = rng.normal(size=p["dt_bias"].shape).astype(np.float32)
    p["D"] = rng.normal(size=p["D"].shape).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    return rcfg, cfg, p, tp, rng


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=MAMBA_TOL, atol=MAMBA_TOL)


@pytest.mark.parametrize("seq,chunk", [(16, 4), (12, 8), (7, 4), (8, 256)])
def test_mamba_forward_matches_reference(seq, chunk):
    rcfg, cfg, p, tp, rng = _setup(seq)
    x = rng.normal(size=(2, seq, cfg.d_model)).astype(np.float32)
    want = jax.jit(RMB.mamba_forward, static_argnums=(2, 3))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), rcfg, chunk)
    got = TMB.mamba_forward(tp, torch.from_numpy(x), cfg, chunk=chunk)
    assert got.shape == x.shape
    _close(got, want)
    # Chunking changes nothing but rounding: one chunk of the whole S.
    whole = TMB.mamba_forward(tp, torch.from_numpy(x), cfg, chunk=seq)
    _close(got, whole.numpy())


def test_largest_divisor_matches_reference():
    for n in (1, 7, 12, 16, 1500, 4096):
        for cap in (1, 4, 8, 256):
            assert TMB._largest_divisor(n, cap) == RMB._largest_divisor(n,
                                                                        cap)


def test_doubling_scan_is_the_recurrence():
    """Inclusive scan of (a, b) pairs: h_t = a_t·h_{t-1} + b_t from 0, and
    the running product of a, at lengths that are and are not powers of
    two."""
    rng = np.random.default_rng(0)
    for n in (1, 5, 8, 13):
        a = rng.uniform(0.5, 1.0, size=(2, n, 3, 4)).astype(np.float32)
        b = rng.normal(size=(2, n, 3, 4)).astype(np.float32)
        cum, h = TMB._scan(torch.from_numpy(a), torch.from_numpy(b))
        want_h, want_cum = np.zeros_like(b), np.zeros_like(a)
        state, prod = np.zeros_like(b[:, 0]), np.ones_like(a[:, 0])
        for t in range(n):
            state = a[:, t] * state + b[:, t]
            prod = prod * a[:, t]
            want_h[:, t], want_cum[:, t] = state, prod
        np.testing.assert_allclose(h.numpy(), want_h, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(cum.numpy(), want_cum, rtol=1e-6,
                                   atol=1e-6)


def test_mamba_decode_step_matches_reference():
    """One step from a random state: output, new conv window, new h; the
    state passed in is not written."""
    rcfg, cfg, p, tp, rng = _setup(5)
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    st = RMB.init_mamba_state(3, rcfg, jnp.float32)
    conv = rng.normal(size=st.conv.shape).astype(np.float32)
    h = rng.normal(size=st.h.shape).astype(np.float32)
    want, want_st = jax.jit(RMB.mamba_decode_step, static_argnums=3)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        RMB.MambaState(jnp.asarray(conv), jnp.asarray(h)), rcfg)
    state = TMB.MambaState(torch.from_numpy(conv.copy()),
                           torch.from_numpy(h.copy()))
    got, new = TMB.mamba_decode_step(tp, torch.from_numpy(x), state, cfg)
    _close(got, want)
    np.testing.assert_array_equal(new.conv.numpy(), np.asarray(want_st.conv))
    _close(new.h, want_st.h)
    np.testing.assert_array_equal(state.conv.numpy(), conv)
    np.testing.assert_array_equal(state.h.numpy(), h)


def test_mamba_decode_chain_matches_forward():
    """Token by token from the zero state == the chunked forward."""
    _, cfg, _, tp, rng = _setup(6)
    x = torch.from_numpy(rng.normal(size=(2, 10, cfg.d_model)).astype(
        np.float32))
    full = TMB.mamba_forward(tp, x, cfg, chunk=4)
    state = TMB.init_mamba_state(2, cfg, torch.float32)
    outs = []
    for t in range(10):
        y, state = TMB.mamba_decode_step(tp, x[:, t:t + 1], state, cfg)
        outs.append(y)
    _close(torch.cat(outs, 1), full.numpy())


def test_init_mamba_matches_reference():
    """Keys, shapes and dtypes as the reference's (``A_log``, ``D`` fp32 in
    a bf16 config); ``A_log`` and the zero leaves equal the reference's."""
    rcfg = dataclasses.replace(ref_get_smoke_config(ARCH),
                               param_dtype="bfloat16")
    cfg = dataclasses.replace(get_smoke_config(ARCH), param_dtype="bfloat16")
    want = RMB.init_mamba(jax.random.PRNGKey(0), rcfg)
    got = TMB.init_mamba(torch.Generator().manual_seed(0), cfg)
    assert list(got) == list(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype), k
    for k in ("A_log", "D", "conv_b", "dt_bias"):
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k], np.float32))


def test_softplus_against_logaddexp():
    """``F.softplus`` (linear above 20) against ``jax.nn.softplus``
    (``logaddexp(x, 0)``) across the threshold, fp32 and bf16."""
    x = np.linspace(-30, 40, 2001).astype(np.float32)
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        got = torch.nn.functional.softplus(torch.from_numpy(x).to(tdt))
        want = jax.nn.softplus(jnp.asarray(x, jdt))
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=1e-6 if tdt == torch.float32
                                   else 8e-3, atol=1e-7)
