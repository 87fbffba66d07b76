"""Port parity: the MoE layer (``repro_torch.models.moe``) against the
reference's ``repro.models.moe`` on the same numpy inputs, on the CPU.

Parameters come from the reference's ``init_moe`` (carried across as
numpy); activations from a seeded numpy generator.  Cases: the qwen2-moe
smoke config (6 experts, top-2, a shared MLP) at S=8, where no pair is
dropped, and at S=64; dbrx's smoke config (no shared MLP) at S=64; the
same with a non-gated GELU; and a router biased towards one expert, so
that most pairs overflow its capacity and are dropped.

Tolerance: output and aux loss within ``MOE_TOL`` (atol and rtol 1e-4).
The largest differences seen were 3.1e-5 on outputs of magnitude 158
(2e-7 relative: the reference's fan-in init scales the expert weights by
E^-1/2) and 0 on the aux loss (fp32).  A flipped routing choice would
move an output by far more than the tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as RM
import repro_torch.models.moe as TM
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro_torch.configs import get_smoke_config
from repro_torch.models import round_up

MOE_TOL = 1e-4


def _configs(arch, **changes):
    return (dataclasses.replace(ref_get_smoke_config(arch), **changes),
            dataclasses.replace(get_smoke_config(arch), **changes))


def _params(rcfg, seed):
    """The reference's init as numpy."""
    return jax.tree.map(np.array, RM.init_moe(jax.random.PRNGKey(seed), rcfg))


def _inputs(cfg, seq, seed, params, bias=None):
    """Activations N(0, 1); ``bias`` {expert: logit} makes feature 0 a
    constant 3 and adds to those experts' router weights on it, so each
    gets that much more logit on every token (no probability underflows,
    so top-k meets no ties)."""
    x = np.random.default_rng(seed).normal(
        size=(2, seq, cfg.d_model)).astype(np.float32)
    for expert, logit in (bias or {}).items():
        x[..., 0] = 3.0
        params["router"][0, expert] += logit / 3.0
    return x


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _dropped(x, params, cfg):
    """Pairs over capacity, counted from the router alone (numpy)."""
    b, s, _ = x.shape
    spec = cfg.moe
    logits = x.astype(np.float32) @ params["router"]
    ids = np.argsort(-logits, axis=-1, kind="stable")[..., :spec.top_k]
    cap = round_up(max(int(s * spec.top_k / spec.n_experts
                           * spec.capacity_factor), 1), 8)
    counts = np.stack([np.bincount(r.reshape(-1), minlength=spec.n_experts)
                       for r in ids])
    return int(np.maximum(counts - cap, 0).sum())


CASES = {
    "qwen-s8": ("qwen2-moe-a2.7b", {}, 8, None),
    "qwen-s64": ("qwen2-moe-a2.7b", {}, 64, None),
    "dbrx-s64": ("dbrx-132b", {}, 64, None),
    "dbrx-gelu": ("dbrx-132b", {"act": "gelu"}, 64, None),
    "qwen-hot": ("qwen2-moe-a2.7b", {}, 64, 0),
}


@pytest.mark.parametrize("case", CASES)
def test_moe_mlp_matches_reference(case):
    arch, changes, seq, hot = CASES[case]
    rcfg, cfg = _configs(arch, **changes)
    params = _params(rcfg, seed=len(case))
    x = _inputs(cfg, seq, seq, params, None if hot is None else {hot: 9.0})
    want, want_aux = jax.jit(RM.moe_mlp, static_argnums=2)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), rcfg)
    got, aux = TM.moe_mlp(_as_torch(params), torch.from_numpy(x), cfg)
    assert got.shape == (2, seq, cfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MOE_TOL,
                               atol=MOE_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=MOE_TOL,
                               atol=MOE_TOL)
    dropped = _dropped(x, params, cfg)
    if seq == 8:
        assert dropped == 0
    if hot is not None:
        assert dropped >= seq          # half of each row's first choices


def test_moe_mlp_is_deterministic_and_drops_to_zero():
    """The same call twice is equal bit for bit; a token all of whose
    choices are dropped gets only the shared MLP's output."""
    rcfg, cfg = _configs("dbrx-132b")
    params = _params(rcfg, seed=3)
    # Every token's two choices are experts 0 and 1: 64 pairs each against
    # a capacity of 40, so tokens 40… lose both.
    x = _inputs(cfg, 64, 3, params, {0: 18.0, 1: 9.0})
    tx = torch.from_numpy(x)
    a, _ = TM.moe_mlp(_as_torch(params), tx, cfg)
    b, _ = TM.moe_mlp(_as_torch(params), tx, cfg)
    assert torch.equal(a, b)
    assert float(a[:, :40].abs().min()) > 0
    assert float(a[:, 40:].abs().max()) == 0.0    # dbrx has no shared MLP


def test_init_moe_matches_reference_tree():
    """Keys, shapes and dtypes as the reference's, router fp32 in a bf16
    config; the seeded draw is repeatable."""
    rcfg, cfg = _configs("qwen2-moe-a2.7b", param_dtype="bfloat16")
    want = jax.eval_shape(lambda k: RM.init_moe(k, rcfg),
                          jax.random.PRNGKey(0))
    got = TM.init_moe(torch.Generator().manual_seed(0), cfg)
    again = TM.init_moe(torch.Generator().manual_seed(0), cfg)

    def spec(tree):
        if isinstance(tree, dict):
            return {k: spec(v) for k, v in tree.items()}
        return tuple(tree.shape), str(tree.dtype).removeprefix("torch.")

    assert spec(got) == spec(want)
    assert got["router"].dtype == torch.float32
    assert got["wi"].dtype == torch.bfloat16
    for k in ("router", "wi", "wo"):
        assert torch.equal(got[k], again[k])
