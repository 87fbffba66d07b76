"""The unified LM covering all ten assigned architectures (port of
``repro.models.lm``).

Decoder stack = ``cfg.pattern`` (a super-block of heterogeneous layers)
repeated ``cfg.n_repeats`` times.  Parameters are a nested dict with the
reference's tree: ``"blocks"`` (and, for enc-dec archs, ``"encoder"`` and
``"cross"``) hold every leaf stacked over the repeats on a leading axis,
as the reference's ``jax.vmap`` init makes them, and where the reference
runs ``jax.lax.scan`` over that axis the port loops over slice ``[r]``.
Enc-dec archs (whisper) add a bidirectional encoder stack and per-layer
cross-attention; VLM/audio frontends are stubs that consume precomputed
patch/frame embeddings, as in the reference.  With ``cfg.remat`` and grad
mode on, each repeat's super-block (its cross-attention and MoE aux
included) and each encoder layer run under
``torch.utils.checkpoint``, where the reference wraps its scan step in
``jax.checkpoint``; under ``torch.no_grad()`` (decode, serving) nothing
is rematerialized.

Decode state differs from the reference's as ``attention.py`` says:
positions are Python ints and every state is advanced in place, so a
``DecodeState`` passed to ``decode_step`` is advanced too.  A KV cache
gets its new row written in place; a recurrent state (Mamba, mLSTM,
sLSTM) is computed into fresh tensors and copied into slice ``[r]`` of
its stacked state.  Only a KV cache carries a length.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.utils.checkpoint import checkpoint

from .. import prng
from ..device import DeviceLike, resolve_device
from ..launch.sharding import from_local, placements
from ..tree import tree_map
from . import attention as attn
from . import blocks
from .act_sharding import constrain, lift, local, shard_start
from .common import (const_init, dense_init, draw_tree, rmsnorm,
                     sinusoidal_positions, softcap)
from .config import LayerSpec, ModelConfig


class DecodeState(NamedTuple):
    """Carried serving state: per-layer stacks + position counter."""

    layer_states: Any          # per pattern position, stacked (n_repeats, ...)
    cross_kv: Optional[Any]    # enc-dec: per-layer (k, v) from encoder
    position: int              # tokens decoded so far


def _at(tree, r: int):
    """Slice ``[r]`` of every leaf of a stacked tree (views, not copies)."""
    if isinstance(tree, dict):
        return {k: _at(v, r) for k, v in tree.items()}
    return tree[r]


def _remat(cfg, fn, x, r: int):
    """``fn(x, r)``, rematerialized when ``cfg.remat`` and grad mode is on
    (the reference's ``jax.checkpoint`` of each scanned repeat): autograd
    keeps only the inputs and recomputes the body in the backward."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, x, r, use_reentrant=False)
    return fn(x, r)


def _state_at(state, r: int):
    """Slice ``[r]`` of every tensor of a stacked decode state (views)."""
    return type(state)(*(f[r] if isinstance(f, torch.Tensor) else f
                         for f in state))


def _lookup_sharded(tokens: DTensor, table: DTensor) -> DTensor:
    """``F.embedding`` from a DTensor table whose vocab may be sharded:
    each position looks up the ids its rows hold and gives zeros for the
    rest, a partial sum that the caller's ``constrain`` reduces.  (DTensor's
    own lookup gives a masked partial, whose reduction has no gradient.)
    The table's other dim is gathered first: the tokens' batch rows are
    split over those positions."""
    mesh = table.device_mesh
    start, vocab = shard_start(table, 0)
    table = table.redistribute(mesh, [
        p if i in vocab else Replicate()
        for i, p in enumerate(table.placements)])
    tokens = tokens.redistribute(mesh, [
        Replicate() if i in vocab else p
        for i, p in enumerate(tokens.placements)])
    n = table.to_local().shape[0]

    def look(tok, tab):
        ids = tok.long() - start
        hit = (ids >= 0) & (ids < n)
        return F.embedding(ids.clamp(0, n - 1), tab) * hit[..., None].to(
            tab.dtype)

    return local(look, [Partial() if i in vocab else p
                        for i, p in enumerate(tokens.placements)],
                 tokens, table)


class LM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # ------------------------------------------------------------- init ----
    def describe(self, rng: torch.Tensor) -> dict:
        """The parameter tree with each leaf described, not drawn
        (``common.Dense``/``Fixed``), under the reference's key splits: five
        top keys, and per-repeat keys for the stacked super-blocks, the
        encoder and the cross-attention.  A stacked leaf holds the batch of
        its repeats' keys, so its slice ``[r]`` is the draw under repeat
        ``r``'s key, as the reference's ``jax.vmap`` over keys gives it."""
        cfg = self.cfg
        k_embed, k_head, k_layers, k_enc, k_cross = prng.split(rng, 5)

        def init_superblock(keys):
            ks = prng.split(keys, len(cfg.pattern))
            return {f"layer{i}": blocks.init_block(ks[..., i, :], cfg, spec)
                    for i, spec in enumerate(cfg.pattern)}

        params = {
            # d^-1/2 scale keeps tied-head logits ~N(0,1) at init.
            "embed": dense_init(k_embed, (cfg.padded_vocab, cfg.d_model),
                                cfg.pdtype, scale=cfg.d_model ** -0.5),
            "final_norm": const_init(rng, (cfg.d_model,), cfg.pdtype, 0.0),
            "blocks": init_superblock(prng.split(k_layers, cfg.n_repeats)),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(
                k_head, (cfg.d_model, cfg.padded_vocab), cfg.pdtype)
        if cfg.n_encoder_layers:
            params["encoder"] = blocks.init_block(
                prng.split(k_enc, cfg.n_encoder_layers), cfg,
                LayerSpec("attn", "dense"))
            params["enc_norm"] = const_init(rng, (cfg.d_model,), cfg.pdtype,
                                            0.0)

            def init_cross(keys):  # one cross-attention per decoder layer
                ks = prng.split(keys, len(cfg.pattern))
                return {f"layer{i}": {
                    "xnorm": const_init(keys, (cfg.d_model,), cfg.pdtype,
                                        0.0),
                    "xattn": attn.init_attention(ks[..., i, :], cfg),
                } for i in range(len(cfg.pattern))}

            params["cross"] = init_cross(prng.split(k_cross, cfg.n_repeats))
        return params

    def init(self, rng: torch.Tensor, device: DeviceLike = None, *,
             mesh=None, shardings=None) -> dict:
        """The parameters under the key ``rng`` (``prng.PRNGKey``), the
        reference's values, on ``device`` (the card unless given;
        ``"meta"`` gives the shapes alone and draws nothing).

        With a ``DeviceMesh`` ``mesh`` and ``shardings`` (the
        ``param_shardings`` tree of PartitionSpecs), every leaf is a
        DTensor placed by its spec, and this rank draws only its own box
        of each leaf: no collective, and no leaf made whole.  Each box
        equals the same slice of the whole draw bit for bit.
        """
        dev = resolve_device(device)
        described = self.describe(rng)
        if mesh is None:
            return draw_tree(described, dev)

        def shard(leaf, spec):
            place = placements(spec, mesh)
            box, offset = compute_local_shape_and_global_offset(
                leaf.shape, mesh, place)
            return from_local(leaf.draw(dev, block=(offset, box)), mesh,
                              place, leaf.shape)

        return tree_map(shard, described, shardings)

    # -------------------------------------------------------- embedding ----
    def embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        table = params["embed"]
        if isinstance(table, DTensor):
            e = _lookup_sharded(tokens, table)
        else:
            e = F.embedding(tokens, table)
        return constrain(e.to(self.cfg.cdtype), "dp", None, None)

    def head_matrix(self, params) -> torch.Tensor:
        return (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])

    def unembed(self, params, x_normed: torch.Tensor) -> torch.Tensor:
        """Project (already final-normed) hidden states to vocab logits."""
        out = x_normed @ self.head_matrix(params).to(x_normed.dtype)
        out = constrain(out, "dp", None, "tp")
        return softcap(out.to(torch.float32), self.cfg.logit_softcap)

    def logits(self, params, x: torch.Tensor) -> torch.Tensor:
        return self.unembed(params,
                            rmsnorm(x, params["final_norm"],
                                    self.cfg.norm_eps))

    # ---------------------------------------------------------- encoder ----
    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """Bidirectional encoder over precomputed frontend embeddings."""
        cfg = self.cfg
        s = frames.shape[1]
        x = frames.to(cfg.cdtype) + lift(sinusoidal_positions(
            s, cfg.d_model, frames.device).to(cfg.cdtype)[None], frames)
        positions = lift(torch.arange(s, device=frames.device).expand(
            frames.shape[:2]), frames)
        enc_spec = LayerSpec("attn", "dense")

        def layer(x, r):
            y, _ = blocks.block_forward(_at(params["encoder"], r), x, cfg,
                                        enc_spec, positions, causal=False)
            return y

        for r in range(cfg.n_encoder_layers):
            x = _remat(cfg, layer, x, r)
        return rmsnorm(x, params["enc_norm"], cfg.norm_eps)

    def _cross_kv(self, params, enc_out: torch.Tensor):
        """Precompute per-decoder-layer cross K/V (prefill-time, cached)."""
        cfg = self.cfg
        out = {}
        for i in range(len(cfg.pattern)):
            p = params["cross"][f"layer{i}"]["xattn"]
            ks, vs = [], []
            for r in range(cfg.n_repeats):
                ks.append(attn._split_heads(enc_out @ p["wk"][r],
                                            cfg.n_kv_heads, cfg.hd))
                vs.append(attn._split_heads(enc_out @ p["wv"][r],
                                            cfg.n_kv_heads, cfg.hd))
            out[f"layer{i}"] = (torch.stack(ks), torch.stack(vs))
        return out

    def _cross(self, params, cross_kv, r: int, i: int, x):
        cp = _at(params["cross"][f"layer{i}"], r)
        k, v = (t[r] for t in cross_kv[f"layer{i}"])
        h = rmsnorm(x, cp["xnorm"], self.cfg.norm_eps)
        return x + attn.attention_cross(cp["xattn"], h, k, v)

    # ---------------------------------------------------------- forward ----
    def forward_hidden(self, params, tokens: torch.Tensor,
                       frames: Optional[torch.Tensor] = None,
                       patch_embeds: Optional[torch.Tensor] = None):
        """Final-normed hidden states (B, S_tokens, D) + aux loss."""
        cfg = self.cfg
        x = self.embed(params, tokens)
        if patch_embeds is not None:               # VLM stub: prepend patches
            x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
        s = x.shape[1]
        positions = lift(torch.arange(s, device=x.device).expand(
            x.shape[0], s), x)

        cross_kv = None
        if cfg.n_encoder_layers:
            enc_out = self.encode(params, frames)
            cross_kv = self._cross_kv(params, enc_out)

        def superblock(x, r):
            # Repeat r's parameters are sliced here, inside the
            # rematerialized function, so the recompute slices the stacked
            # leaves again and their gradients land in the stacked leaves.
            layer_params = _at(params["blocks"], r)
            aux = lift(torch.zeros((), dtype=torch.float32,
                                   device=x.device), x)
            for i, spec in enumerate(cfg.pattern):
                x, a = blocks.block_forward(layer_params[f"layer{i}"], x,
                                            cfg, spec, positions)
                aux = aux + a
                if cross_kv is not None:
                    x = self._cross(params, cross_kv, r, i, x)
            return x, aux

        auxs = []
        for r in range(cfg.n_repeats):
            x, a = _remat(cfg, superblock, x, r)
            auxs.append(a)
        aux = torch.sum(torch.stack(auxs))
        if patch_embeds is not None:               # only token positions score
            x = x[:, patch_embeds.shape[1]:]
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return x, aux

    def forward(self, params, tokens: torch.Tensor,
                frames: Optional[torch.Tensor] = None,
                patch_embeds: Optional[torch.Tensor] = None):
        """Full-sequence logits (training / prefill)."""
        x, aux = self.forward_hidden(params, tokens, frames=frames,
                                     patch_embeds=patch_embeds)
        return self.unembed(params, x), aux

    # ----------------------------------------------------------- decode ----
    def init_decode_state(self, params, batch: int, max_len: int,
                          frames: Optional[torch.Tensor] = None
                          ) -> DecodeState:
        cfg = self.cfg
        dev = params["embed"].device

        def stacked(proto):
            return type(proto)(*(
                torch.zeros((cfg.n_repeats,) + tuple(f.shape), dtype=f.dtype,
                            device=dev) if isinstance(f, torch.Tensor) else f
                for f in proto))

        # All-zeros states, stacked over repeats (the loop slices dim 0);
        # the prototypes on meta give the shapes alone.
        layer_states = tuple(
            stacked(blocks.init_block_state(cfg, spec, batch, max_len,
                                            device="meta"))
            for spec in cfg.pattern)
        cross_kv = None
        if cfg.n_encoder_layers:
            enc_out = self.encode(params, frames)
            cross_kv = self._cross_kv(params, enc_out)
        return DecodeState(layer_states, cross_kv, 0)

    def decode_step(self, params, state: DecodeState, token: torch.Tensor):
        """One serving step. token: (B,) int → (logits (B, V), state)."""
        cfg = self.cfg
        x = self.embed(params, token[:, None])
        for r in range(cfg.n_repeats):
            layer_params = _at(params["blocks"], r)
            for i, spec in enumerate(cfg.pattern):
                view = _state_at(state.layer_states[i], r)
                x, new = blocks.block_decode(layer_params[f"layer{i}"], x,
                                             view, cfg, spec)
                if spec.mixer != "attn":      # fresh tensors: into [r]
                    for dst, src in zip(view, new):
                        dst.copy_(src)
                if state.cross_kv is not None:
                    x = self._cross(params, state.cross_kv, r, i, x)
        logits = self.logits(params, x)[:, 0]
        # Every attention layer wrote its cache row in place: one step
        # longer each.
        new_states = tuple(
            attn.KVCache(c.k, c.v, c.length + 1)
            if isinstance(c, attn.KVCache) else c
            for c in state.layer_states)
        return logits, DecodeState(new_states, state.cross_kv,
                                   state.position + 1)
