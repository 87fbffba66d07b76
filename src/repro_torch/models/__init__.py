"""Model zoo: unified LM over the assigned architectures (port of
``repro.models``; the attention-family archs run, see ``blocks.py``)."""
from .config import (LayerSpec, MambaSpec, ModelConfig, MoESpec, XLSTMSpec,
                     dense_pattern, round_up)
from .lm import LM, DecodeState

__all__ = ["LayerSpec", "MambaSpec", "ModelConfig", "MoESpec", "XLSTMSpec",
           "dense_pattern", "round_up", "LM", "DecodeState"]
