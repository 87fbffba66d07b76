"""llama3.2-1b [dense] — small llama3. [hf:meta-llama/Llama-3.2-1B; unverified]

16L, d_model=2048, 32H (GQA kv=8), d_ff=8192, vocab=128256.
"""
from ..models import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b", family="dense", d_model=2048, n_heads=32,
        n_kv_heads=8, d_ff=8192, vocab_size=128256,
        pattern=(LayerSpec("attn", "dense"),), n_repeats=16,
        act="swiglu", rope_theta=500_000.0, tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b-smoke", family="dense", d_model=128, n_heads=4,
        n_kv_heads=1, d_ff=384, vocab_size=512,
        pattern=(LayerSpec("attn", "dense"),), n_repeats=2,
        act="swiglu", rope_theta=500_000.0, tie_embeddings=True,
        param_dtype="float32", compute_dtype="float32", remat=False)
