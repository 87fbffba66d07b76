"""xlstm-125m [ssm] — sLSTM + mLSTM blocks. [arXiv:2405.04517; unverified]

12L, d_model=768, 4H, vocab=50304, d_ff=0 (blocks are self-contained).
Super-block of 6 (sLSTM at position 3, mLSTM elsewhere — the paper's ~1:7
sLSTM ratio at this depth), repeated 2× → sLSTM at layers 3 and 9.
"""
from ..models import LayerSpec, ModelConfig, XLSTMSpec


def _pattern():
    return tuple(LayerSpec("slstm" if i == 3 else "mlstm", "none")
                 for i in range(6))


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm", d_model=768, n_heads=4,
        n_kv_heads=4, d_ff=0, vocab_size=50304,
        pattern=_pattern(), n_repeats=2, act="gelu",
        xlstm=XLSTMSpec(proj_factor=2.0), tie_embeddings=True,
        subquadratic=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m-smoke", family="ssm", d_model=64, n_heads=2,
        n_kv_heads=2, d_ff=0, vocab_size=512,
        pattern=_pattern(), n_repeats=1, act="gelu",
        xlstm=XLSTMSpec(proj_factor=2.0), tie_embeddings=True,
        subquadratic=True,
        param_dtype="float32", compute_dtype="float32", remat=False)
