"""dbrx-132b [moe] — 16 experts top-4, fine-grained.
[hf:databricks/dbrx-base; unverified]

40L, d_model=6144, 48H (GQA kv=8), expert d_ff=10752, vocab=100352.
"""
from ..models import LayerSpec, ModelConfig, MoESpec


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe", d_model=6144, n_heads=48,
        n_kv_heads=8, d_ff=10752, vocab_size=100352,
        pattern=(LayerSpec("attn", "moe"),), n_repeats=40, act="swiglu",
        rope_theta=500_000.0,
        # TP-within-expert rather than EP: XLA SPMD lowers the EP combine
        # scatter as a replicated-buffer all-reduce (34 GB/device —
        # EXPERIMENTS.md §Perf); revisit with an explicit shard_map
        # all-to-all dispatch.
        moe=MoESpec(n_experts=16, top_k=4, d_expert_ff=10752,
                    shard_experts=False))


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b-smoke", family="moe", d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=512,
        pattern=(LayerSpec("attn", "moe"),), n_repeats=2, act="swiglu",
        moe=MoESpec(n_experts=4, top_k=2, d_expert_ff=128),
        param_dtype="float32", compute_dtype="float32", remat=False)
