"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE.
[arXiv:2403.19887; hf]

72L, d_model=8192, 64H (GQA kv=8), d_ff=24576, vocab=65536; MoE 16e top-2.
Super-block = 8 layers: attention at index 4 (the 1:7 ratio), Mamba
elsewhere; MoE replaces the MLP on every second layer.  72 = 9 repeats × 8.
"""
from ..models import LayerSpec, MambaSpec, ModelConfig, MoESpec


def _pattern():
    layers = []
    for i in range(8):
        mixer = "attn" if i == 4 else "mamba"
        mlp = "moe" if i % 2 == 1 else "dense"
        layers.append(LayerSpec(mixer, mlp))
    return tuple(layers)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid", d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=24576, vocab_size=65536,
        pattern=_pattern(), n_repeats=9, act="swiglu",
        # TP-within-expert (see dbrx config note on the EP combine).
        moe=MoESpec(n_experts=16, top_k=2, d_expert_ff=24576,
                    shard_experts=False),
        mamba=MambaSpec(d_state=16, d_conv=4, expand=2),
        subquadratic=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b-smoke", family="hybrid", d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
        pattern=_pattern(), n_repeats=1, act="swiglu",
        moe=MoESpec(n_experts=4, top_k=2, d_expert_ff=128),
        mamba=MambaSpec(d_state=4, d_conv=4, expand=2),
        subquadratic=True,
        param_dtype="float32", compute_dtype="float32", remat=False)
