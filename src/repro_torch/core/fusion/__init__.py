"""Operator fusion of ML models into LAQ star joins (paper §3), in torch."""
from .operators import (DecisionTreeGEMM, LinearOperator, random_tree,
                        reference_tree_eval, tree_from_arrays)
from .pipeline import (PrefusedStar, predict_fused, predict_fused_kernel,
                       predict_fused_matmul, predict_nonfused,
                       predict_nonfused_kernel, predict_nonfused_matmul,
                       prefuse, prefuse_dims)
from .planner import FusionDecision, plan_fusion

__all__ = [
    "LinearOperator", "DecisionTreeGEMM", "tree_from_arrays", "random_tree",
    "reference_tree_eval", "PrefusedStar", "prefuse", "prefuse_dims",
    "predict_fused", "predict_fused_kernel", "predict_fused_matmul",
    "predict_nonfused", "predict_nonfused_kernel", "predict_nonfused_matmul",
    "FusionDecision", "plan_fusion",
]
