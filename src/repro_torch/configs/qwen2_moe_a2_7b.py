"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4, fine-grained experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

24L, d_model=2048, 16H (GQA kv=16), expert d_ff=1408, vocab=151936.
The 4 shared experts are fused into one 4×1408-wide shared MLP (identical
compute).  60 experts don't divide the 16-way model axis, so expert weights
shard like dense weights (TP within expert) instead of EP — see DESIGN.md.
"""
from ..models import LayerSpec, ModelConfig, MoESpec


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe", d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=1408, vocab_size=151936,
        pattern=(LayerSpec("attn", "moe"),), n_repeats=24, act="swiglu",
        moe=MoESpec(n_experts=60, top_k=4, d_expert_ff=1408,
                    n_shared=4, d_shared_ff=4 * 1408, shard_experts=False))


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b-smoke", family="moe", d_model=64, n_heads=2,
        n_kv_heads=2, d_ff=96, vocab_size=512,
        pattern=(LayerSpec("attn", "moe"),), n_repeats=2, act="swiglu",
        moe=MoESpec(n_experts=6, top_k=2, d_expert_ff=96,
                    n_shared=2, d_shared_ff=192, shard_experts=False),
        param_dtype="float32", compute_dtype="float32", remat=False)
