"""Hand-written CUDA kernels (sm_90a) for the paper's compute hot spots.

Each kernel subpackage has ``ops.py`` (the wrapper: checks, launch, launch
counter) and ``ref.py`` (the plain PyTorch version); the CUDA sources live
in ``csrc/`` and build at first use (:mod:`._build`).

=====================  ==============================================
kernel                 replaces (TPU Pallas kernel)
=====================  ==============================================
fused_star_gather      src/repro/kernels/fused_star_gather/kernel.py:53
tree_predict           src/repro/kernels/tree_predict/kernel.py:34
=====================  ==============================================
"""
from .fused_star_gather import fused_star_gather, fused_star_gather_ref
from .tree_predict import tree_predict, tree_predict_ref

__all__ = ["fused_star_gather", "fused_star_gather_ref", "tree_predict",
           "tree_predict_ref"]
