"""Port parity: the xLSTM blocks (``repro_torch.models.xlstm``) against the
reference's ``repro.models.xlstm`` on the same numpy inputs, on the CPU.

Parameters come from the reference's ``init_mlstm``/``init_slstm`` at
xlstm-125m's smoke width (d_model 64, 2 heads, mLSTM inner width 128),
with the sLSTM bias drawn at random; activations and states from a seeded
numpy generator.  The mLSTM runs over two chunks (S=16, chunk 8) and at
its default chunk; the sLSTM over S=9.

Tolerance: ``XLSTM_TOL`` (atol and rtol 1e-4) on outputs and new states.
The largest difference seen was 3.0e-7 on outputs of magnitude 0.9
(fp32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.xlstm as RX
import repro_torch.models.xlstm as TX
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro_torch.configs import get_smoke_config

XLSTM_TOL = 1e-4
ARCH = "xlstm-125m"


def _setup(kind, seed):
    rcfg, cfg = ref_get_smoke_config(ARCH), get_smoke_config(ARCH)
    init = RX.init_mlstm if kind == "mlstm" else RX.init_slstm
    p = jax.tree.map(np.array, init(jax.random.PRNGKey(seed), rcfg))
    rng = np.random.default_rng(seed)
    if kind == "slstm":
        p["b"] = rng.normal(size=p["b"].shape).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    return rcfg, cfg, jax.tree.map(jnp.asarray, p), tp, rng


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=XLSTM_TOL, atol=XLSTM_TOL)


def _chain(step, tp, x, state, cfg):
    outs = []
    for t in range(x.shape[1]):
        y, state = step(tp, x[:, t:t + 1], state, cfg)
        outs.append(y)
    return torch.cat(outs, 1), state


@pytest.mark.parametrize("chunk", (8, 256))
def test_mlstm_forward_matches_reference(chunk):
    rcfg, cfg, rp, tp, rng = _setup("mlstm", chunk)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    want = jax.jit(RX.mlstm_forward, static_argnums=(2, 3))(
        rp, jnp.asarray(x), rcfg, chunk)
    got = TX.mlstm_forward(tp, torch.from_numpy(x), cfg, chunk=chunk)
    assert got.shape == x.shape
    _close(got, want)
    # The recurrent decode chain from zero gives the same sequence.
    chain, _ = _chain(TX.mlstm_decode_step, tp, torch.from_numpy(x),
                      TX.init_mlstm_state(2, cfg), cfg)
    _close(chain, want)


def test_mlstm_decode_step_matches_reference():
    rcfg, cfg, rp, tp, rng = _setup("mlstm", 3)
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    st = RX.init_mlstm_state(3, rcfg)
    c = rng.normal(size=st.c.shape).astype(np.float32)
    n = rng.normal(size=st.n.shape).astype(np.float32)
    want, want_st = jax.jit(RX.mlstm_decode_step, static_argnums=3)(
        rp, jnp.asarray(x), RX.MLSTMState(jnp.asarray(c), jnp.asarray(n)),
        rcfg)
    state = TX.MLSTMState(torch.from_numpy(c.copy()),
                          torch.from_numpy(n.copy()))
    got, new = TX.mlstm_decode_step(tp, torch.from_numpy(x), state, cfg)
    _close(got, want)
    _close(new.c, want_st.c)
    _close(new.n, want_st.n)
    np.testing.assert_array_equal(state.c.numpy(), c)    # not written


def test_slstm_forward_and_decode_match_reference():
    """The sequential forward against the reference's scan; the decode
    chain from zero against both; one step from a random state."""
    rcfg, cfg, rp, tp, rng = _setup("slstm", 4)
    x = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    want = jax.jit(RX.slstm_forward, static_argnums=2)(rp, jnp.asarray(x),
                                                       rcfg)
    got = TX.slstm_forward(tp, torch.from_numpy(x), cfg)
    _close(got, want)
    chain, _ = _chain(TX.slstm_decode_step, tp, torch.from_numpy(x),
                      TX.init_slstm_state(2, cfg), cfg)
    _close(chain, want)

    xs = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    c, n, h = (rng.uniform(0.1, 2.0, size=(2, cfg.d_model)).astype(
        np.float32) for _ in range(3))
    want, want_st = jax.jit(RX.slstm_decode_step, static_argnums=3)(
        rp, jnp.asarray(xs), RX.SLSTMState(*map(jnp.asarray, (c, n, h))),
        rcfg)
    got, new = TX.slstm_decode_step(
        tp, torch.from_numpy(xs),
        TX.SLSTMState(*map(torch.from_numpy, (c, n, h))), cfg)
    _close(got, want)
    for g, w in zip(new, want_st):
        _close(g, w)


def test_init_xlstm_matches_reference():
    """Keys, shapes and dtypes as the reference's; the zero states are
    separate tensors (a decode writes each in place)."""
    rcfg, cfg = ref_get_smoke_config(ARCH), get_smoke_config(ARCH)
    for tinit, rinit in ((TX.init_mlstm, RX.init_mlstm),
                         (TX.init_slstm, RX.init_slstm)):
        want = rinit(jax.random.PRNGKey(0), rcfg)
        got = tinit(torch.Generator().manual_seed(0), cfg)
        assert list(got) == list(want)
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: v.shape for k, v in want.items()}
    st = TX.init_slstm_state(2, cfg)
    assert len({t.data_ptr() for t in st}) == 3
    assert TX.init_mlstm_state(2, cfg).c.shape == RX.init_mlstm_state(
        2, rcfg).c.shape
