"""Port parity in bf16: smollm-360m's and qwen2-moe-a2.7b's smoke configs
with ``param_dtype`` and ``compute_dtype`` set to bfloat16 in both
packages, the reference's bf16 weights carried across (its fp32 router
too), on the CPU.

Tolerance: ``forward`` logits within ``BF16_LOGIT_TOL`` (atol 0.125: 8
bf16 ulps at magnitude 2–4) of the reference's; the largest difference
seen was 0.068 on logits of magnitude 3.9 (seeds 1–3; argmax equal at 97–
100 % of all positions).  Both packages round every bf16
op's output, but XLA keeps a fused chain of element-wise ops in fp32 and
the two round the matmuls' accumulations differently, so 1-ulp
differences arise and compound over the layers.  The argmax tokens are
compared only where the reference's top-two gap is at least twice the
tolerance (each of the two logits may move by it); at least a quarter of
the positions must qualify.  The MoE aux loss within rtol 1e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import LM as RefLM
from repro_torch.configs import get_smoke_config
from repro_torch.interop import lm_params_from_arrays
from repro_torch.models import LM

BF16_LOGIT_TOL = 0.125
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")


def _bf16_pair(arch, seed):
    rcfg = dataclasses.replace(ref_get_smoke_config(arch), **BF16)
    cfg = dataclasses.replace(get_smoke_config(arch), **BF16)
    ref = RefLM(rcfg)
    rp = jax.jit(ref.init)(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, rp)
    return ref, rp, tree, LM(cfg), lm_params_from_arrays(cfg, tree,
                                                         device="cpu")


@pytest.mark.parametrize("arch", ("smollm-360m", "qwen2-moe-a2.7b"))
def test_bf16_forward_matches_reference(arch):
    ref, rp, _, lm, params = _bf16_pair(arch, seed=1)
    tokens = np.random.default_rng(1).integers(
        0, lm.cfg.vocab_size, (4, 16)).astype(np.int32)
    want, want_aux = jax.jit(ref.forward)(rp, jnp.asarray(tokens))
    got, aux = lm.forward(params, torch.from_numpy(tokens))
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=BF16_LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-3)
    top = np.sort(want, axis=-1)[..., -2:]
    clear = top[..., 1] - top[..., 0] >= 2 * BF16_LOGIT_TOL
    assert clear.mean() >= 0.25, clear.mean()
    np.testing.assert_array_equal(got.numpy().argmax(-1)[clear],
                                  want.argmax(-1)[clear])


@pytest.mark.parametrize("arch", ("qwen2-moe-a2.7b", "jamba-1.5-large-398b"))
def test_fp32_leaves_survive_the_carry_across(arch):
    """In a bf16 config the MoE router and Mamba's ``A_log`` and ``D``
    arrive in fp32, equal to the reference's; every other leaf in bf16."""
    _, _, tree, _, params = _bf16_pair(arch, seed=0)
    seen = set()

    def check(got, want, path):
        if isinstance(got, dict):
            for k in got:
                check(got[k], want[k], path + (k,))
            return
        if path[-1] in ("router", "A_log", "D"):
            seen.add(path[-1])
            assert want.dtype == np.float32 and got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            assert got.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(got.float().numpy(),
                                          want.astype(np.float32))

    check(params, tree, ())
    assert seen == ({"router"} if arch == "qwen2-moe-a2.7b"
                    else {"router", "A_log", "D"})
