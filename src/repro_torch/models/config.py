"""Architecture configuration for the assigned model pool (port of
``repro.models.config``).

One ``ModelConfig`` describes any of the ten assigned architectures.  The
layer stack is expressed as a *super-block pattern*: a short list of
``LayerSpec`` repeated ``n_repeats`` times (the port loops over the
repeats; each parameter is stacked over them on a leading axis, as the
reference's ``lax.scan`` reads it).  E.g.
jamba-1.5-large is 9 repeats of an 8-layer pattern (7×mamba + 1×attention,
MoE on odd layers); dense archs are N repeats of a single layer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_expert_ff: int
    n_shared: int = 0            # shared experts (qwen2-moe), fused into one
    d_shared_ff: int = 0         # total shared-expert hidden width
    capacity_factor: float = 1.25
    shard_experts: bool = True   # EP over the model axis (needs E % model == 0)


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0             # 0 → ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class XLSTMSpec:
    proj_factor: float = 2.0     # mLSTM up-projection
    conv_kernel: int = 4


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer inside the super-block pattern."""

    mixer: str          # "attn" | "mamba" | "mlstm" | "slstm"
    mlp: str            # "dense" | "moe" | "none"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | encdec | vlm | audio
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[LayerSpec, ...]  # super-block layer pattern
    n_repeats: int                  # total layers = len(pattern) * n_repeats
    head_dim: int = 0               # 0 → d_model // n_heads
    act: str = "swiglu"             # swiglu | geglu | gelu
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    moe: Optional[MoESpec] = None
    mamba: Optional[MambaSpec] = None
    xlstm: Optional[XLSTMSpec] = None
    # Encoder (enc-dec archs); encoder layers use the same width/heads.
    n_encoder_layers: int = 0
    encoder_seq: int = 0            # e.g. whisper: 1500 precomputed frames
    # Modality frontend stub: "none" | "audio" | "patch".  Stubs mean
    # input_specs() provides precomputed frame/patch embeddings (assignment).
    frontend: str = "none"
    n_patches: int = 0              # vlm: patch embeddings prepended
    # Numerics / memory.
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    # Attention flavor of the arch ("full" archs skip long_500k).
    subquadratic: bool = False

    # ---- derived ----------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.n_repeats

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, 256)

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def n_params(self) -> int:
        """Parameter count (embedding included once if tied)."""
        d, hd = self.d_model, self.hd
        total = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        per_pattern = 0
        for spec in self.pattern:
            if spec.mixer == "attn":
                per_pattern += d * hd * (self.n_heads + 2 * self.n_kv_heads)
                per_pattern += self.n_heads * hd * d
            elif spec.mixer == "mamba":
                m = self.mamba
                d_in = m.expand * d
                dt_rank = m.dt_rank or -(-d // 16)
                per_pattern += d * 2 * d_in            # in_proj
                per_pattern += m.d_conv * d_in          # conv
                per_pattern += d_in * (dt_rank + 2 * m.d_state)
                per_pattern += dt_rank * d_in + d_in * m.d_state  # dt_proj, A
                per_pattern += d_in * d                 # out_proj
            elif spec.mixer in ("mlstm", "slstm"):
                x = self.xlstm
                d_in = int(x.proj_factor * d) if spec.mixer == "mlstm" else d
                per_pattern += d * d_in * 2 + 4 * d_in * d_in // (
                    1 if spec.mixer == "mlstm" else 1)
                per_pattern += d_in * d
            gates = 2 if self.act in ("swiglu", "geglu") else 1
            if spec.mlp == "dense":
                per_pattern += d * self.d_ff * gates + self.d_ff * d
            elif spec.mlp == "moe":
                e = self.moe
                per_pattern += d * e.n_experts          # router
                per_pattern += e.n_experts * (
                    d * e.d_expert_ff * gates + e.d_expert_ff * d)
                if e.d_shared_ff:
                    per_pattern += d * e.d_shared_ff * gates + e.d_shared_ff * d
            per_pattern += 2 * d                        # norms
        total += per_pattern * self.n_repeats
        # Encoder stack (attention + dense mlp per layer).
        enc = self.n_encoder_layers * (
            d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            + d * self.d_ff * 2 + self.d_ff * d + 4 * d)
        # Decoder cross-attention (enc-dec archs).
        if self.n_encoder_layers:
            enc += self.n_layers * (
                d * hd * (self.n_heads + 2 * self.n_kv_heads)
                + self.n_heads * hd * d + 2 * d)
        return total + enc

    def active_params(self) -> int:
        """Active parameters per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.n_params()
        e = self.moe
        gates = 2 if self.act in ("swiglu", "geglu") else 1
        per_expert = e.d_expert_ff * self.d_model * (gates + 1)
        n_moe_layers = sum(1 for s in self.pattern
                           if s.mlp == "moe") * self.n_repeats
        inactive = per_expert * (e.n_experts - e.top_k) * n_moe_layers
        return self.n_params() - inactive


def dense_pattern(n_layers: int) -> Tuple[Tuple[LayerSpec, ...], int]:
    return (LayerSpec("attn", "dense"),), n_layers
