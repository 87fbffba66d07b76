"""The unified LM over the attention-family architectures (port of
``repro.models.lm``).

Decoder stack = ``cfg.pattern`` (a super-block of layers) repeated
``cfg.n_repeats`` times.  Parameters are a nested dict with the reference's
tree: ``"blocks"`` (and, for enc-dec archs, ``"encoder"`` and ``"cross"``)
hold every leaf stacked over the repeats on a leading axis, as the
reference's ``jax.vmap`` init makes them, and where the reference runs
``jax.lax.scan`` over that axis the port loops over slice ``[r]``.  Enc-dec
archs (whisper) add a bidirectional encoder stack and per-layer
cross-attention; VLM/audio frontends are stubs that consume precomputed
patch/frame embeddings, as in the reference.

Archs with a Mamba, mLSTM/sLSTM or MoE layer raise ``NotImplementedError``
at construction (see ``blocks.py``).  Decode state differs from the
reference's as ``attention.py`` says: positions are Python ints and the KV
caches are written in place, so a ``DecodeState`` passed to
``decode_step`` is advanced too.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from . import attention as attn
from . import blocks
from .act_sharding import constrain
from .common import dense_init, rmsnorm, sinusoidal_positions, softcap
from .config import LayerSpec, ModelConfig


class DecodeState(NamedTuple):
    """Carried serving state: per-layer stacks + position counter."""

    layer_states: Any          # per pattern position, stacked (n_repeats, ...)
    cross_kv: Optional[Any]    # enc-dec: per-layer (k, v) from encoder
    position: int              # tokens decoded so far


def _stack(trees):
    """One tree whose leaves stack the given trees' leaves on a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _at(tree, r: int):
    """Slice ``[r]`` of every leaf of a stacked tree (views, not copies)."""
    if isinstance(tree, dict):
        return {k: _at(v, r) for k, v in tree.items()}
    return tree[r]


class LM:
    def __init__(self, cfg: ModelConfig):
        for spec in cfg.pattern:
            blocks.check_spec(spec)
        self.cfg = cfg

    # ------------------------------------------------------------- init ----
    def init(self, generator: torch.Generator,
             device: DeviceLike = None) -> dict:
        """Random parameters drawn from ``generator``, on ``device`` (the
        card unless given; ``"meta"`` gives the shapes alone)."""
        cfg = self.cfg
        dev = resolve_device(device)

        def init_superblock():
            return {f"layer{i}": blocks.init_block(generator, cfg, spec, dev)
                    for i, spec in enumerate(cfg.pattern)}

        params = {
            # d^-1/2 scale keeps tied-head logits ~N(0,1) at init.
            "embed": dense_init(generator, (cfg.padded_vocab, cfg.d_model),
                                cfg.pdtype, scale=cfg.d_model ** -0.5,
                                device=dev),
            "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.pdtype,
                                      device=dev),
            "blocks": _stack([init_superblock()
                              for _ in range(cfg.n_repeats)]),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(
                generator, (cfg.d_model, cfg.padded_vocab), cfg.pdtype,
                device=dev)
        if cfg.n_encoder_layers:
            enc_spec = LayerSpec("attn", "dense")
            params["encoder"] = _stack([
                blocks.init_block(generator, cfg, enc_spec, dev)
                for _ in range(cfg.n_encoder_layers)])
            params["enc_norm"] = torch.zeros((cfg.d_model,), dtype=cfg.pdtype,
                                             device=dev)

            def init_cross():       # one cross-attention per decoder layer
                return {f"layer{i}": {
                    "xnorm": torch.zeros((cfg.d_model,), dtype=cfg.pdtype,
                                         device=dev),
                    "xattn": attn.init_attention(generator, cfg, device=dev),
                } for i in range(len(cfg.pattern))}

            params["cross"] = _stack([init_cross()
                                      for _ in range(cfg.n_repeats)])
        return params

    # -------------------------------------------------------- embedding ----
    def embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        e = F.embedding(tokens, params["embed"])
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
        x = frames.to(cfg.cdtype) + sinusoidal_positions(
            s, cfg.d_model, frames.device).to(cfg.cdtype)[None]
        positions = torch.arange(s, device=frames.device).expand(
            frames.shape[:2])
        enc_spec = LayerSpec("attn", "dense")
        for r in range(cfg.n_encoder_layers):
            x, _ = blocks.block_forward(_at(params["encoder"], r), x, cfg,
                                        enc_spec, positions, causal=False)
        return rmsnorm(x, params["enc_norm"], cfg.norm_eps)

    def _cross_kv(self, params, enc_out: torch.Tensor):
        """Precompute per-decoder-layer cross K/V (prefill-time, cached)."""
        cfg = self.cfg
        b, t, _ = enc_out.shape
        out = {}
        for i in range(len(cfg.pattern)):
            p = params["cross"][f"layer{i}"]["xattn"]
            ks, vs = [], []
            for r in range(cfg.n_repeats):
                ks.append((enc_out @ p["wk"][r]).reshape(
                    b, t, cfg.n_kv_heads, cfg.hd))
                vs.append((enc_out @ p["wv"][r]).reshape(
                    b, t, cfg.n_kv_heads, cfg.hd))
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
        positions = torch.arange(s, device=x.device).expand(x.shape[0], s)

        cross_kv = None
        if cfg.n_encoder_layers:
            enc_out = self.encode(params, frames)
            cross_kv = self._cross_kv(params, enc_out)

        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for r in range(cfg.n_repeats):
            layer_params = _at(params["blocks"], r)
            for i, spec in enumerate(cfg.pattern):
                x, a = blocks.block_forward(layer_params[f"layer{i}"], x,
                                            cfg, spec, positions)
                aux = aux + a
                if cross_kv is not None:
                    x = self._cross(params, cross_kv, r, i, x)
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
        shape = (cfg.n_repeats, batch, max_len, cfg.n_kv_heads, cfg.hd)
        # All-zeros caches, stacked over repeats (the loop slices dim 0).
        layer_states = tuple(
            attn.KVCache(torch.zeros(shape, dtype=cfg.cdtype, device=dev),
                         torch.zeros(shape, dtype=cfg.cdtype, device=dev), 0)
            for _ in cfg.pattern)
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
                c = state.layer_states[i]
                x, _ = blocks.block_decode(
                    layer_params[f"layer{i}"], x,
                    attn.KVCache(c.k[r], c.v[r], c.length), cfg, spec)
                if state.cross_kv is not None:
                    x = self._cross(params, state.cross_kv, r, i, x)
        logits = self.logits(params, x)[:, 0]
        # Every layer wrote its cache row in place: one step longer each.
        new_states = tuple(attn.KVCache(c.k, c.v, c.length + 1)
                           for c in state.layer_states)
        return logits, DecodeState(new_states, state.cross_kv,
                                   state.position + 1)
