"""GQA attention: the blocked online-softmax (flash) forward for training /
prefill, and the cached decode path (port of ``repro.models.attention``).

The flash forward is mathematically identical to naive attention (tested)
but never materializes the (S×S) score matrix: a loop over KV blocks inside
a loop over Q blocks carries (max, denom, acc), the standard online-softmax
restructuring.  Its backward is the reference's custom VJP, a
FlashAttention-2 backward: ``_Flash`` is a ``torch.autograd.Function``
that saves only the O(S) residuals (q, k, v, the fp32 output and the
per-row log-sum-exp) and recomputes each (q-block, kv-block) pair's
probabilities from them, so autograd never holds a block's (qb×kb)
probability tensor.  Both passes run eagerly in plain torch, in the
reference's order and dtypes (fp32 logits, softmax and gradients, the
same additive causal penalty); their matmuls are ``einsum``s, as the
reference computes them outside any kernel.

Decode state differs from the reference's in one way: ``KVCache.length``
is a Python int, not a 0-d device array, and ``attention_decode`` writes
the new K/V row into the cache in place.  The port runs eagerly, so a
device-side position would cost a host sync per layer and token to slice
by; the arithmetic is the same.

On DTensors (the LM sharded on a ``DeviceMesh``) the flash forward and
backward run on each position's shards (``act_sharding.local``): q, k and
v are split over batch and heads alike, so each position's attention is
exact on its own rows and heads.  A cache whose sequence is sharded (KV
heads that do not divide the model axis) takes its new row on the
position that holds it (``_write_row``).
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

from torch.distributed.tensor import DTensor, Replicate, Shard

from .act_sharding import (constrain, flatten, lift, local, shard_start,
                           unflatten)
from .. import prng
from .common import apply_rope, dense_init

NEG_INF = -1e30


def init_attention(key, cfg, cross: bool = False):
    """The projections under the reference's four keys, described (drawn by
    ``common.draw_tree`` or a box at a time)."""
    d, hd = cfg.d_model, cfg.hd
    ks = prng.split(key, 4)
    return {
        "wq": dense_init(ks[..., 0, :], (d, cfg.n_heads * hd), cfg.pdtype),
        "wk": dense_init(ks[..., 1, :], (d, cfg.n_kv_heads * hd),
                         cfg.pdtype),
        "wv": dense_init(ks[..., 2, :], (d, cfg.n_kv_heads * hd),
                         cfg.pdtype),
        "wo": dense_init(ks[..., 3, :], (cfg.n_heads * hd, d), cfg.pdtype),
    }


def _split_heads(x, n_heads, hd):
    return unflatten(x, -1, (n_heads, hd))


def qkv(params, x, cfg, positions=None, rope: bool = True):
    q = _split_heads(x @ params["wq"], cfg.n_heads, cfg.hd)
    k = _split_heads(x @ params["wk"], cfg.n_kv_heads, cfg.hd)
    v = _split_heads(x @ params["wv"], cfg.n_kv_heads, cfg.hd)
    q = constrain(q, "dp", None, "tp", None)
    k = constrain(k, "dp", None, "tp", None)
    v = constrain(v, "dp", None, "tp", None)
    if rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _group(q, n_kv):
    """(B,S,H,hd) → (B,S,KV,G,hd) grouping query heads onto KV heads."""
    return unflatten(q, 2, (n_kv, q.shape[2] // n_kv))


def naive_attention(q, k, v, causal: bool, q_offset: int = 0,
                    kv_len: Union[int, torch.Tensor, None] = None
                    ) -> torch.Tensor:
    """Reference attention (tests + decode). q:(B,Sq,H,hd) k/v:(B,Skv,KV,hd).

    ``kv_len`` masks cache rows at and past it: a (B,) tensor as in the
    reference, or one int for every row (the port's decode).  DTensors
    split alike over batch and heads (and whole along the sequence) run on
    each position's shards; others, such as a cache split along its
    sequence, run as DTensor ops."""
    if (isinstance(q, DTensor) and q.placements == k.placements
            == v.placements and not any(
                isinstance(p, Shard) and p.dim in (1, 3)
                for p in q.placements)
            and not isinstance(kv_len, torch.Tensor)):
        return local(lambda q, k, v: _naive(q, k, v, causal, q_offset,
                                            kv_len),
                     q.placements, q, k, v)
    return _naive(q, k, v, causal, q_offset, kv_len)


def _naive(q, k, v, causal, q_offset, kv_len):
    n_kv = k.shape[2]
    qg = _group(q, n_kv)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bskgh,btkh->bkgst", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    sq, skv = q.shape[1], k.shape[1]
    dev = logits.device
    if causal:
        qpos = torch.arange(sq, device=dev) + q_offset
        mask = qpos[:, None] >= torch.arange(skv, device=dev)[None, :]
        logits = torch.where(lift(mask[None, None, None], logits), logits,
                             NEG_INF)
    if kv_len is not None:
        kpos = torch.arange(skv, device=dev)
        if isinstance(kv_len, torch.Tensor):
            mask = (kpos[None, :] < kv_len[:, None])[:, None, None, None]
        else:
            mask = lift(kpos < kv_len, logits)                    # (Skv,)
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.to(torch.float32))
    return flatten(out, 2, -1).to(q.dtype)


def _flash_fwd_impl(q, k, v, causal, q_block, kv_block):
    """Forward pass; returns (out (B,S,KV,G,hd) fp32, lse (nq,B,KV,G,qb))."""
    b, s, h, hd = q.shape
    n_kv = k.shape[2]
    g = h // n_kv
    nq, nk = s // q_block, k.shape[1] // kv_block
    scale = hd ** -0.5
    dev = q.device

    qg = _group(q, n_kv).to(torch.float32)               # (B,S,KV,G,hd)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    q_blocks = qg.reshape(b, nq, q_block, n_kv, g, hd)
    k_blocks = kf.reshape(b, nk, kv_block, n_kv, hd)
    v_blocks = vf.reshape(b, nk, kv_block, n_kv, hd)

    outs, lses = [], []
    for qidx in range(nq):
        qb_ = q_blocks[:, qidx]                          # (B,qb,KV,G,hd)
        q_pos = qidx * q_block + torch.arange(q_block, device=dev)
        m = torch.full((b, n_kv, g, q_block), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, n_kv, g, q_block), dtype=torch.float32,
                        device=dev)
        acc = torch.zeros((b, n_kv, g, q_block, hd), dtype=torch.float32,
                          device=dev)
        for kidx in range(nk):
            kb_, vb_ = k_blocks[:, kidx], v_blocks[:, kidx]
            k_pos = kidx * kv_block + torch.arange(kv_block, device=dev)
            logits = torch.einsum("bskgh,btkh->bkgst", qb_, kb_) * scale
            if causal:
                # An additive penalty, as the reference adds it.
                pen = (q_pos[:, None] < k_pos[None, :]).to(
                    torch.float32) * NEG_INF
                logits = logits + pen[None, None, None]
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgst,btkh->bkgsh", p, vb_)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B,KV,G,qb,hd)
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
        outs.append(out.permute(0, 3, 1, 2, 4))           # (B,qb,KV,G,hd)
    out = torch.stack(outs, dim=1).reshape(b, s, n_kv, g, hd)
    return out, torch.stack(lses)


def _flash_bwd_impl(q, k, v, o, lse, do, causal, q_block, kv_block):
    """FlashAttention-2 backward: recompute p per (q, kv) block pair from
    the O(S) residuals (q, k, v, o (B,S,KV,G,hd) fp32, lse); returns (dq,
    dk, dv) in the dtypes of q, k, v."""
    b, s, h, hd = q.shape
    n_kv = k.shape[2]
    g = h // n_kv
    nq, nk = s // q_block, k.shape[1] // kv_block
    scale = hd ** -0.5
    dev = q.device

    qg = _group(q, n_kv).to(torch.float32)
    dog = _group(do, n_kv).to(torch.float32)              # (B,S,KV,G,hd)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    delta = torch.sum(dog * o, dim=-1)                     # (B,S,KV,G)

    q_blocks = qg.reshape(b, nq, q_block, n_kv, g, hd)
    do_blocks = dog.reshape(b, nq, q_block, n_kv, g, hd)
    delta_blocks = delta.reshape(b, nq, q_block, n_kv, g).permute(
        1, 0, 3, 4, 2)                                     # (nq,B,KV,G,qb)
    k_blocks = kf.reshape(b, nk, kv_block, n_kv, hd)
    v_blocks = vf.reshape(b, nk, kv_block, n_kv, hd)
    # lse from the forward: (nq, B, KV, G, qb)

    dk = torch.zeros((b, k.shape[1], n_kv, hd), dtype=torch.float32,
                     device=dev)
    dv = torch.zeros_like(dk)
    dqs = []
    for qidx in range(nq):
        qb_, dob_ = q_blocks[:, qidx], do_blocks[:, qidx]
        deltab_, lseb_ = delta_blocks[qidx], lse[qidx]
        q_pos = qidx * q_block + torch.arange(q_block, device=dev)
        dq_acc = torch.zeros((b, q_block, n_kv, g, hd), dtype=torch.float32,
                             device=dev)
        for kidx in range(nk):
            kb_, vb_ = k_blocks[:, kidx], v_blocks[:, kidx]
            k_pos = kidx * kv_block + torch.arange(kv_block, device=dev)
            logits = torch.einsum("bskgh,btkh->bkgst", qb_, kb_) * scale
            if causal:
                pen = (q_pos[:, None] < k_pos[None, :]).to(
                    torch.float32) * NEG_INF
                logits = logits + pen[None, None, None]
            p = torch.exp(logits - lseb_[..., None])      # (B,KV,G,qb,kb)
            dv_blk = torch.einsum("bkgst,bskgh->btkh", p, dob_)
            dp = torch.einsum("bskgh,btkh->bkgst", dob_, vb_)
            ds = p * (dp - deltab_[..., None]) * scale
            dq_blk = torch.einsum("bkgst,btkh->bskgh", ds, kb_)
            dk_blk = torch.einsum("bkgst,bskgh->btkh", ds, qb_)
            at = slice(kidx * kv_block, (kidx + 1) * kv_block)
            dk[:, at] = dk[:, at] + dk_blk
            dv[:, at] = dv[:, at] + dv_blk
            dq_acc = dq_acc + dq_blk
        dqs.append(dq_acc)
    dq = torch.stack(dqs, dim=1).reshape(b, s, h, hd)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    """Flash attention with the FlashAttention-2 backward (the module
    docstring): q (B,S,H,hd), k/v (B,S,KV,hd) → (B,S,H,hd)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_block, kv_block):
        out, lse = _flash_fwd_impl(q, k, v, causal, q_block, kv_block)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.blocks = (causal, q_block, kv_block)
        b, s, h, hd = q.shape
        return out.reshape(b, s, h, hd).to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(q, k, v, out, lse, do, *ctx.blocks)
        return dq, dk, dv, None, None, None


def _flash(q, k, v, causal, q_block, kv_block):
    """``_Flash`` on each position's shards when q is a DTensor: k and v
    take q's placements (batch and heads split alike; the sequence and
    head dims must be whole)."""
    if isinstance(q, DTensor):
        if any(isinstance(p, Shard) and p.dim in (1, 3)
               for p in q.placements):
            q = q.redistribute(q.device_mesh, [
                Replicate() if isinstance(p, Shard) and p.dim in (1, 3)
                else p for p in q.placements])
        k, v = (t.redistribute(q.device_mesh, q.placements)
                for t in (k, v))
    return local(lambda q, k, v: _Flash.apply(q, k, v, causal, q_block,
                                              kv_block),
                 getattr(q, "placements", None), q, k, v)


def _largest_divisor(n: int, cap: int) -> int:
    for b in range(min(cap, n), 0, -1):
        if n % b == 0:
            return b
    return 1


def flash_attention(q, k, v, causal: bool = True, q_block: int = 512,
                    kv_block: int = 512) -> torch.Tensor:
    """Blocked online-softmax attention; exact, O(S·block) memory, with
    the FlashAttention-2 backward (see the module docstring).

    q (B,S,H,hd); k,v (B,S,KV,hd) → (B,S,H·hd).  Block sizes snap to the
    largest divisor of S (e.g. whisper's 1500-frame encoder → 500); if the
    divisor degenerates, fall back to naive attention.
    """
    s = q.shape[1]
    q_block = _largest_divisor(s, min(q_block, s))
    kv_block = _largest_divisor(k.shape[1], min(kv_block, k.shape[1]))
    if q_block < 64 or kv_block < 64:       # prime-ish lengths: not worth it
        return naive_attention(q, k, v, causal=causal)
    out = _flash(q, k, v, causal, q_block, kv_block)
    return flatten(out, 2, 3)


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S_max, KV, hd)
    v: torch.Tensor
    length: int           # tokens already cached (a Python int: see above)


def init_kv_cache(batch: int, max_len: int, cfg, dtype,
                  device=None) -> KVCache:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


def attention_train(params, x, cfg, positions, causal=True,
                    use_flash=True) -> torch.Tensor:
    """Full-sequence attention (training / prefill), no cache."""
    q, k, v = qkv(params, x, cfg, positions)
    if use_flash and x.shape[1] > 1024:
        # KV heads expanded to the full head count, as the reference does
        # for its model-axis sharding.
        g = cfg.n_heads // cfg.n_kv_heads
        if g > 1:
            k = constrain(torch.repeat_interleave(k, g, dim=2),
                          "dp", None, "tp", None)
            v = constrain(torch.repeat_interleave(v, g, dim=2),
                          "dp", None, "tp", None)
        out = flash_attention(q, k, v, causal=causal)
    else:
        out = naive_attention(q, k, v, causal=causal)
    out = out @ params["wo"]
    return constrain(out, "dp", None, None)


def attention_decode(params, x, cfg, cache: KVCache,
                     rope: bool = True):
    """Single-token decode with KV cache append. x: (B, 1, D).

    Writes row ``cache.length`` of ``cache.k``/``cache.v`` in place and
    returns them in a cache one longer."""
    pos = lift(torch.full((x.shape[0], 1), cache.length, dtype=torch.int32,
                          device=x.device), x)
    q, k, v = qkv(params, x, cfg, pos, rope=rope)
    _write_row(cache.k, cache.length, k)
    _write_row(cache.v, cache.length, v)
    new_len = cache.length + 1
    out = naive_attention(q, cache.k, cache.v, causal=False, kv_len=new_len)
    return out @ params["wo"], KVCache(cache.k, cache.v, new_len)


def _write_row(cache: torch.Tensor, at: int, row: torch.Tensor) -> None:
    """``cache[:, at] = row`` in place: cache (B, S, KV, hd), row (B, 1,
    KV, hd).  On a DTensor cache the row takes the cache's placements with
    the sequence whole, and a position whose shard of a sharded sequence
    does not hold ``at`` writes nothing."""
    if not isinstance(cache, DTensor):
        cache[:, at:at + 1] = row.to(cache.dtype)
        return
    row = row.to(cache.dtype).redistribute(cache.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim == 1 else p
        for p in cache.placements]).to_local()
    local_cache = cache.to_local()
    start, _ = shard_start(cache, 1)
    if start <= at < start + local_cache.shape[1]:
        local_cache[:, at - start:at - start + 1] = row


def attention_cross(params, x, k, v) -> torch.Tensor:
    """Cross-attention against precomputed encoder K/V (no RoPE, no mask)."""
    cfg_heads = params["wq"].shape[1] // k.shape[-1]
    q = _split_heads(x @ params["wq"], cfg_heads, k.shape[-1])
    out = naive_attention(q, k, v, causal=False)
    return out @ params["wo"]
