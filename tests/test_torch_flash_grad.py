"""Port parity: the flash attention backward (``repro_torch.models.
attention._Flash``, the reference's FlashAttention-2 custom VJP in plain
torch) against the reference's custom-VJP gradients and against the
port's ``naive_attention`` under autograd.

Shapes: those of ``tests/test_models_smoke.py``'s flash cases (B 2, H 4
over 2 KV heads, hd 16; S 256 with blocks 64×32, S 128 with blocks
32×16).  ``flash_attention`` snaps blocks under 64 to naive attention in
both packages, so the 32×16 case calls ``_flash`` directly, as the
reference's custom VJP is defined on it.  Causal and not.

Tolerances (the reference test's): outputs atol/rtol 2e-5, gradients
atol/rtol 2e-4.  Seen: outputs within 4.8e-7 of the reference's and
6.0e-7 of naive attention; gradients within 4.8e-6 of the reference's
custom VJP and 1.4e-5 of naive autograd.

Memory: autograd through ``_Flash`` saves only q, k, v, the fp32 output
and the log-sum-exp — O(S) bytes — where naive attention saves its
(S×S) probabilities: doubling S doubles the flash graph's saved bytes and
quadruples naive's (counted with ``saved_tensors_hooks``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as RA
from repro_torch.models import attention as TA


def _qkvw(seed, b, s, h, kv, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, hd)).astype(np.float32),
            rng.normal(size=(b, s, kv, hd)).astype(np.float32),
            rng.normal(size=(b, s, kv, hd)).astype(np.float32),
            rng.normal(size=(h * hd,)).astype(np.float32))


def _port_grads(fn, q, k, v, w):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = fn(*ts)
    (out.reshape(out.shape[0], out.shape[1], -1)
     * torch.from_numpy(w)).sum().backward()
    return out.detach(), [t.grad for t in ts]


CASES = [  # (seed, S, q_block, kv_block, via flash_attention)
    (3, 256, 64, 32, False), (3, 256, 64, 64, True),
    (7, 128, 32, 16, False)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("seed,s,qb,kb,public", CASES,
                         ids=["s256-64x32", "s256-64x64-public",
                              "s128-32x16"])
def test_flash_grads_match_reference_vjp_and_naive(seed, s, qb, kb, public,
                                                   causal):
    b, h, kv, hd = 2, 4, 2, 16
    q, k, v, w = _qkvw(seed, b, s, h, kv, hd)
    if public:
        def port(*a):
            return TA.flash_attention(*a, causal=causal, q_block=qb,
                                      kv_block=kb)

        def ref(*a):
            return RA.flash_attention(*a, causal=causal, q_block=qb,
                                      kv_block=kb)
    else:
        def port(*a):
            return TA._flash(*a, causal, qb, kb)

        def ref(*a):
            return RA._flash(*a, causal, qb, kb)

    def ref_loss(*a):
        return jnp.sum(ref(*a).reshape(b, s, h * hd) * w)

    ref_g = jax.jit(jax.grad(ref_loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(x) for x in (q, k, v)))
    out, got = _port_grads(port, q, k, v, w)
    nout, naive = _port_grads(
        lambda *a: TA.naive_attention(*a, causal=causal), q, k, v, w)
    np.testing.assert_allclose(out.reshape(b, s, -1).numpy(),
                               nout.numpy(), rtol=2e-5, atol=2e-5)
    ref_out = jax.jit(ref)(*(jnp.asarray(x) for x in (q, k, v)))
    np.testing.assert_allclose(out.reshape(b, s, -1).numpy(),
                               np.asarray(ref_out).reshape(b, s, -1),
                               rtol=2e-5, atol=2e-5)
    for name, g, rg, ng in zip("qkv", got, ref_g, naive):
        np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=2e-4,
                                   atol=2e-4, err_msg=f"d{name} vs ref")
        np.testing.assert_allclose(g.numpy(), ng.numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=f"d{name} vs naive")


def test_flash_grads_in_bf16_follow_the_inputs_dtype():
    """bf16 q/k/v (the full configs' dtype): the backward computes in
    fp32 and returns bf16 grads within bf16 rounding of the fp32 ones."""
    b, s, h, kv, hd = 1, 256, 4, 2, 16
    q, k, v, w = _qkvw(11, b, s, h, kv, hd)
    ts = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
          for x in (q, k, v)]
    out = TA._flash(*ts, True, 64, 64)
    assert out.dtype == torch.bfloat16
    (out.float().reshape(b, s, -1) * torch.from_numpy(w)).sum().backward()
    ref = [torch.from_numpy(x).to(torch.bfloat16).float().requires_grad_(
        True) for x in (q, k, v)]
    out32 = TA._flash(*ref, True, 64, 64)
    (out32.reshape(b, s, -1) * torch.from_numpy(w)).sum().backward()
    for t, r in zip(ts, ref):
        assert t.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(t.grad.float().numpy(), r.grad.numpy(),
                                   rtol=2 ** -7, atol=2 ** -7 * float(
                                       r.grad.abs().max()))


def _saved_bytes(fn, s):
    """Bytes autograd saves for ``fn`` at sequence length ``s`` (each
    storage counted once)."""
    b, h, kv, hd = 1, 4, 2, 16
    q, k, v, w = _qkvw(0, b, s, h, kv, hd)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn(*ts)
        (out.reshape(b, s, -1) * torch.from_numpy(w)).sum()
    return sum(seen.values())


def test_flash_graph_saves_o_of_s_bytes():
    def flash(*a):
        return TA._flash(*a, True, 128, 128)

    def naive(*a):
        return TA.naive_attention(*a, causal=True)

    f1, f2 = _saved_bytes(flash, 512), _saved_bytes(flash, 1024)
    n1, n2 = _saved_bytes(naive, 512), _saved_bytes(naive, 1024)
    assert f2 <= 2.1 * f1                     # linear in S
    assert n2 >= 3.5 * n1                     # quadratic in S
    assert f2 * 10 < n2
    # q, k, v, the fp32 out (B,S,KV,G,hd), lse and w: nothing S×S.
    s, h, kv, hd = 1024, 4, 2, 16
    want = 4 * (s * h * hd + 2 * s * kv * hd + s * h * hd + s * h + h * hd)
    assert f2 == want
