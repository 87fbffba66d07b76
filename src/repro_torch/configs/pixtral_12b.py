"""pixtral-12b [vlm] — pixtral-ViT + mistral-nemo backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]

40L, d_model=5120, 32H (GQA kv=8), d_ff=14336, vocab=131072.
Vision frontend is a STUB per assignment: input_specs() provides
precomputed patch embeddings prepended to the token stream.
"""
from ..models import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="vlm", d_model=5120, n_heads=32,
        n_kv_heads=8, d_ff=14336, vocab_size=131072, head_dim=128,
        pattern=(LayerSpec("attn", "dense"),), n_repeats=40,
        act="swiglu", rope_theta=1_000_000.0,
        frontend="patch", n_patches=256)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b-smoke", family="vlm", d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=384, vocab_size=512, head_dim=32,
        pattern=(LayerSpec("attn", "dense"),), n_repeats=2,
        act="swiglu", frontend="patch", n_patches=8,
        param_dtype="float32", compute_dtype="float32", remat=False)
