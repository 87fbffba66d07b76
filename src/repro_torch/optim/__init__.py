"""Optimizer substrate: AdamW, schedules, grad compression (port of
``repro.optim``)."""
from .adamw import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                    clip_by_global_norm, global_norm)
from .schedule import constant, warmup_cosine, warmup_linear
from .compression import Compressed, compress, compress_tree, decompress

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "global_norm", "constant", "warmup_cosine",
           "warmup_linear", "Compressed", "compress", "compress_tree",
           "decompress"]
