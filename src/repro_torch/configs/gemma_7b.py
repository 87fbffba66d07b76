"""gemma-7b [dense] — GeGLU, head_dim=256. [arXiv:2403.08295; hf]

28L, d_model=3072, 16H (GQA kv=16), d_ff=24576, vocab=256000.
"""
from ..models import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b", family="dense", d_model=3072, n_heads=16,
        n_kv_heads=16, d_ff=24576, vocab_size=256000, head_dim=256,
        pattern=(LayerSpec("attn", "dense"),), n_repeats=28,
        act="geglu", tie_embeddings=True, logit_softcap=30.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b-smoke", family="dense", d_model=96, n_heads=2,
        n_kv_heads=2, d_ff=384, vocab_size=512, head_dim=64,
        pattern=(LayerSpec("attn", "dense"),), n_repeats=2,
        act="geglu", tie_embeddings=True, logit_softcap=30.0,
        param_dtype="float32", compute_dtype="float32", remat=False)
