"""``tree_predict``: fused Hummingbird GEMM decision-tree inference."""
from .ops import tree_predict
from .ref import tree_predict_ref

__all__ = ["tree_predict", "tree_predict_ref"]
