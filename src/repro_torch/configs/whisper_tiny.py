"""whisper-tiny [audio] — enc-dec, conv frontend (stub).
[arXiv:2212.04356; unverified]

4L enc + 4L dec, d_model=384, 6H (GQA kv=6), d_ff=1536, vocab=51865.
The conv frontend is a STUB per assignment: input_specs() provides 1500
precomputed mel-frame embeddings (B, 1500, 384).
"""
from ..models import LayerSpec, ModelConfig

ENCODER_FRAMES = 1500


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", family="encdec", d_model=384, n_heads=6,
        n_kv_heads=6, d_ff=1536, vocab_size=51865,
        pattern=(LayerSpec("attn", "dense"),), n_repeats=4,
        act="gelu", n_encoder_layers=4, encoder_seq=ENCODER_FRAMES,
        frontend="audio", tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny-smoke", family="encdec", d_model=64, n_heads=2,
        n_kv_heads=2, d_ff=128, vocab_size=512,
        pattern=(LayerSpec("attn", "dense"),), n_repeats=2,
        act="gelu", n_encoder_layers=2, encoder_seq=16,
        frontend="audio", tie_embeddings=True,
        param_dtype="float32", compute_dtype="float32", remat=False)
