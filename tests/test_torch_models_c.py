"""Port parity, third part: the flash forward, the attention masks and the
shared building blocks (``repro_torch.models.{attention,common}``) against
the reference's, on the CPU.

Tolerances:
  * the flash forward against ``naive_attention`` and against the
    reference's flash forward (``out`` and ``lse``): atol and rtol 2e-5, as
    the reference's test;
  * norms, activations, positions and softcap: atol and rtol 1e-6; RoPE
    at positions up to 4096: 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as RA
import repro.models.common as RC
import repro_torch.models.attention as TA
import repro_torch.models.common as TC

FLASH_TOL = 2e-5
OP_TOL = 1e-6


def _qkv(seed, b=2, s=256, h=4, kv=2, hd=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))]


@pytest.mark.parametrize("causal", (True, False))
def test_flash_forward_matches_naive_and_reference(causal):
    q, k, v = _qkv(3)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    nv = TA.naive_attention(tq, tk, tv, causal=causal).numpy()
    np.testing.assert_allclose(
        nv, np.asarray(RA.naive_attention(*map(jnp.asarray, (q, k, v)),
                                          causal=causal)),
        rtol=FLASH_TOL, atol=FLASH_TOL)
    # 64×64 blocks run the blocked path (below 64 it falls back to naive).
    fl = TA.flash_attention(tq, tk, tv, causal=causal, q_block=64,
                            kv_block=64).numpy()
    np.testing.assert_allclose(fl, nv, rtol=FLASH_TOL, atol=FLASH_TOL)
    # The blocked forward itself, at blocks the reference also runs.
    out, lse = TA._flash_fwd_impl(tq, tk, tv, causal, 64, 32)
    want_out, want_lse = RA._flash_fwd_impl(*map(jnp.asarray, (q, k, v)),
                                            causal, 64, 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               rtol=FLASH_TOL, atol=FLASH_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               rtol=FLASH_TOL, atol=FLASH_TOL)
    assert TA._largest_divisor(1500, 512) == RA._largest_divisor(1500, 512)


def test_naive_attention_kv_len_and_decode_mask():
    q, k, v = _qkv(4, s=6)
    q = q[:, :1]
    kv_len = np.array([3, 6], np.int32)
    want = np.asarray(RA.naive_attention(
        *map(jnp.asarray, (q, k, v)), causal=False,
        kv_len=jnp.asarray(kv_len)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = TA.naive_attention(tq, tk, tv, causal=False,
                             kv_len=torch.from_numpy(kv_len))
    np.testing.assert_allclose(got.numpy(), want, rtol=FLASH_TOL,
                               atol=FLASH_TOL)
    # One int for every row is the tensor of that int.
    same = TA.naive_attention(tq, tk, tv, causal=False, kv_len=4)
    assert torch.equal(same, TA.naive_attention(
        tq, tk, tv, causal=False, kv_len=torch.tensor([4, 4])))


def test_common_ops_match_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    pos = rng.integers(0, 4096, size=(2, 5)).astype(np.int32)
    tx, tw, tb = map(torch.from_numpy, (x, w, b))

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=OP_TOL, atol=OP_TOL)

    close(TC.rmsnorm(tx, tw), RC.rmsnorm(jnp.asarray(x), jnp.asarray(w)))
    close(TC.layernorm(tx, tw, tb),
          RC.layernorm(*map(jnp.asarray, (x, w, b))))
    for name in ("swiglu", "geglu", "gelu", "silu"):
        close(TC.act_fn(name)(tx), RC.act_fn(name)(jnp.asarray(x)))
    close(TC.rope_freqs(16, 500_000.0), RC.rope_freqs(16, 500_000.0))
    np.testing.assert_allclose(
        TC.apply_rope(tx, torch.from_numpy(pos), 10_000.0).numpy(),
        np.asarray(RC.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                 10_000.0)), rtol=1e-5, atol=1e-5)
    close(TC.sinusoidal_positions(12, 16), RC.sinusoidal_positions(12, 16))
    close(TC.softcap(tx * 40, 30.0), RC.softcap(jnp.asarray(x) * 40, 30.0))
    assert torch.equal(TC.softcap(tx, 0.0), tx)
    # bf16 in, bf16 out, fp32 inside.
    assert TC.rmsnorm(tx.bfloat16(), tw).dtype == torch.bfloat16
