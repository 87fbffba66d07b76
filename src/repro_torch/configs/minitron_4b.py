"""minitron-4b [dense] — pruned nemotron. [arXiv:2407.14679; hf]

32L, d_model=3072, 24H (GQA kv=8), d_ff=9216, vocab=256000.
"""
from ..models import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b", family="dense", d_model=3072, n_heads=24,
        n_kv_heads=8, d_ff=9216, vocab_size=256000,
        pattern=(LayerSpec("attn", "dense"),), n_repeats=32, act="swiglu")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b-smoke", family="dense", d_model=96, n_heads=3,
        n_kv_heads=1, d_ff=288, vocab_size=512,
        pattern=(LayerSpec("attn", "dense"),), n_repeats=2, act="swiglu",
        param_dtype="float32", compute_dtype="float32", remat=False)
