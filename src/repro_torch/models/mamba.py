"""Mamba (S6 selective SSM) block — chunked parallel scan (port of
``repro.models.mamba``).

The recurrence ``h_t = exp(Δ_t A)·h_{t-1} + Δ_t B_t x_t`` is a first-order
linear recurrence, i.e. an associative operation on (decay, increment)
pairs.  The reference runs ``jax.lax.associative_scan`` inside fixed chunks
and carries the (B, d_inner, N) boundary state across chunks with
``lax.scan``.  Eager torch has no associative scan, so inside each chunk
the port runs a doubling (Hillis–Steele) scan over the chunk axis: log2
(chunk) rounds of element-wise products on (B, chunk, d_inner, N) fp32, a
few dozen launches per chunk instead of one per position.  The carry
across chunks is a loop over chunks, as the reference's ``lax.scan``.
The scan is never the ``exp(cumsum)`` ratio form: ``exp(-Σ Δ·a)`` overflows
within one chunk.

Both scans add the same terms in different trees, so the port agrees with
the reference to fp32 rounding, not bit for bit (the CPU tests hold the
outputs to atol and rtol 1e-4).  ``F.softplus`` returns ``x`` above its
threshold of 20 where ``jax.nn.softplus`` computes ``logaddexp(x, 0)``;
the term dropped there, ``log1p(exp(-x)) < 2.1e-9``, is under half an ulp
of ``x`` in fp32 and bf16, so both round to the same value.

Decode keeps (conv window, h) as explicit state and costs O(1) per token.
``mamba_decode_step`` returns fresh tensors: the conv window's shift is a
``cat`` into a new tensor, never a copy between overlapping views.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .act_sharding import constrain
from .common import dense_init
from .config import ModelConfig


def _dims(cfg: ModelConfig):
    m = cfg.mamba
    d_in = m.expand * cfg.d_model
    dt_rank = m.dt_rank or -(-cfg.d_model // 16)
    return m, d_in, dt_rank


def init_mamba(generator, cfg: ModelConfig, device=None):
    """Projections drawn in the reference's key order; ``A_log`` and ``D``
    are fp32 whatever the config's dtype, as the reference keeps them."""
    m, d_in, dt_rank = _dims(cfg)
    dev = device if device is not None else generator.device
    in_proj = dense_init(generator, (cfg.d_model, 2 * d_in), cfg.pdtype,
                         device=device)
    conv_w = dense_init(generator, (m.d_conv, d_in), cfg.pdtype,
                        device=device)
    x_proj = dense_init(generator, (d_in, dt_rank + 2 * m.d_state),
                        cfg.pdtype, device=device)
    dt_proj = dense_init(generator, (dt_rank, d_in), cfg.pdtype,
                         device=device)
    out_proj = dense_init(generator, (d_in, cfg.d_model), cfg.pdtype,
                          device=device)
    # A initialized to -[1..N] (S4D-real), stored as log.
    a_init = torch.arange(1, m.d_state + 1, dtype=torch.float32,
                          device=dev)[None].repeat(d_in, 1)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((d_in,), dtype=cfg.pdtype, device=dev),
        "x_proj": x_proj,
        "dt_proj": dt_proj,
        "dt_bias": torch.zeros((d_in,), dtype=cfg.pdtype, device=dev),
        "A_log": torch.log(a_init),
        "D": torch.ones((d_in,), dtype=torch.float32, device=dev),
        "out_proj": out_proj,
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 window: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv1d. x (B,S,C), w (K,C). window: (B,K-1,C) past."""
    k = w.shape[0]
    if window is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = window.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + x.shape[1]] * w[i][None, None, :]
    return out + b[None, None, :]


def _ssm_params(params, xc, m):
    dt_rank = params["dt_proj"].shape[0]
    proj = xc @ params["x_proj"]
    dt, b_ssm, c_ssm = torch.split(proj, [dt_rank, m.d_state, m.d_state],
                                   dim=-1)
    dt = F.softplus(dt @ params["dt_proj"]
                    + params["dt_bias"][None, None, :])
    a = -torch.exp(params["A_log"].to(torch.float32))          # (d_in, N)
    return (dt.to(torch.float32), b_ssm.to(torch.float32),
            c_ssm.to(torch.float32), a)


def _scan(decay: torch.Tensor, inc: torch.Tensor):
    """Inclusive scan over dim 1 of the pairs ``(a, b)`` under
    ``(a1, b1) ∘ (a2, b2) = (a2·a1, a2·b1 + b2)``, by doubling: after the
    round with offset o, position t holds the combination of positions
    ``t-2o+1 … t``.  Returns (cumulative decay, state from a zero start)."""
    n = decay.shape[1]
    off = 1
    while off < n:
        head_a, head_b = decay[:, :off], inc[:, :off]
        a2, b2 = decay[:, off:], inc[:, off:]
        inc = torch.cat([head_b, a2 * inc[:, :-off] + b2], dim=1)
        decay = torch.cat([head_a, a2 * decay[:, :-off]], dim=1)
        off *= 2
    return decay, inc


def mamba_forward(params, x: torch.Tensor, cfg: ModelConfig,
                  chunk: int = 256) -> torch.Tensor:
    """Full-sequence selective scan, **chunked**. x: (B, S, D).

    A doubling scan inside chunks of ``_largest_divisor(S, chunk)``
    positions, with the (B, d_inner, N) boundary state carried across
    chunks by a loop (the module docstring says why).
    """
    m, d_in, _ = _dims(cfg)
    b, s, _ = x.shape
    xz = constrain(x @ params["in_proj"], "dp", None, "tp")
    xi, z = torch.chunk(xz, 2, dim=-1)
    xc = F.silu(_causal_conv(xi, params["conv_w"], params["conv_b"]))
    dt, b_ssm, c_ssm, a = _ssm_params(params, xc, m)
    xcf = xc.to(torch.float32)

    chunk = _largest_divisor(s, min(chunk, s))
    h = torch.zeros((b, d_in, m.d_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for start in range(0, s, chunk):
        at = slice(start, start + chunk)
        dt_c, b_c, c_c, xc_c = dt[:, at], b_ssm[:, at], c_ssm[:, at], \
            xcf[:, at]                                       # (B, chunk, ·)
        da = torch.exp(dt_c[..., None] * a[None, None])      # (B,chunk,d,N)
        dbx = (dt_c * xc_c)[..., None] * b_c[:, :, None, :]
        a_cum, h_in = _scan(da, dbx)
        hs = h_in + a_cum * h[:, None]                       # add carry-in
        ys.append(torch.einsum("bsdn,bsn->bsd", hs, c_c))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1)
    y = y + params["D"].to(torch.float32)[None, None] * xcf
    y = (y * F.silu(z.to(torch.float32))).to(x.dtype)
    return y @ params["out_proj"]


def _largest_divisor(n: int, cap: int) -> int:
    for c in range(min(cap, n), 0, -1):
        if n % c == 0:
            return c
    return 1


class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, K-1, d_in) trailing inputs
    h: torch.Tensor     # (B, d_in, N) SSM state


def init_mamba_state(batch: int, cfg: ModelConfig, dtype,
                     device=None) -> MambaState:
    m, d_in, _ = _dims(cfg)
    return MambaState(
        torch.zeros((batch, m.d_conv - 1, d_in), dtype=dtype, device=device),
        torch.zeros((batch, d_in, m.d_state), dtype=torch.float32,
                    device=device))


def mamba_decode_step(params, x: torch.Tensor, state: MambaState,
                      cfg: ModelConfig) -> Tuple[torch.Tensor, MambaState]:
    """Single-token step. x: (B, 1, D); O(1) state update into fresh
    tensors (``state`` is read, not written)."""
    m, d_in, _ = _dims(cfg)
    xz = x @ params["in_proj"]
    xi, z = torch.chunk(xz, 2, dim=-1)                       # (B,1,d_in)
    xc = F.silu(_causal_conv(xi, params["conv_w"], params["conv_b"],
                             window=state.conv))
    new_conv = torch.cat([state.conv[:, 1:], xi.to(state.conv.dtype)],
                         dim=1)
    dt, b_ssm, c_ssm, a = _ssm_params(params, xc, m)
    xcf = xc.to(torch.float32)
    da = torch.exp(dt[:, 0, :, None] * a[None])              # (B,d,N)
    dbx = (dt * xcf)[:, 0, :, None] * b_ssm[:, 0, None, :]
    h = da * state.h + dbx
    y = torch.einsum("bdn,bn->bd", h, c_ssm[:, 0])[:, None, :]
    y = y + params["D"].to(torch.float32)[None, None] * xcf
    y = (y * F.silu(z.to(torch.float32))).to(x.dtype)
    return y @ params["out_proj"], MambaState(new_conv, h)
