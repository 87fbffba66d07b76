"""smollm-360m [dense] — llama-arch small. [hf:HuggingFaceTB/SmolLM; hf]

32L, d_model=960, 15H (GQA kv=5), d_ff=2560, vocab=49152.
"""
from ..models import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m", family="dense", d_model=960, n_heads=15,
        n_kv_heads=5, d_ff=2560, vocab_size=49152,
        pattern=(LayerSpec("attn", "dense"),), n_repeats=32,
        act="swiglu", tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m-smoke", family="dense", d_model=96, n_heads=3,
        n_kv_heads=1, d_ff=256, vocab_size=512,
        pattern=(LayerSpec("attn", "dense"),), n_repeats=2,
        act="swiglu", tie_embeddings=True,
        param_dtype="float32", compute_dtype="float32", remat=False)
