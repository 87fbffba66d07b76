"""ML operators in linear-algebra form (port of
``repro.core.fusion.operators``).

* ``LinearOperator`` — predictions = X @ L + bias.
* ``DecisionTreeGEMM`` — Hummingbird's GEMM tree (paper Fig. 5):
  ``((X·F > v)·H) == h``, a one-hot leaf encoding per row.

Models are small parameter sets built on the host; ``compile_query`` moves
them to its tables' device with :meth:`to`.  The tree builders make the
same numpy draws as the reference, so one seed gives the same arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LinearOperator:
    """predictions = X @ L + bias (k → l); ``bias`` None means zero."""

    L: torch.Tensor                      # (k, l)
    bias: Optional[torch.Tensor] = None  # (l,) or None

    @property
    def k(self) -> int:
        return int(self.L.shape[0])

    @property
    def l(self) -> int:
        return int(self.L.shape[1])

    def to(self, device) -> "LinearOperator":
        return LinearOperator(self.L.to(device),
                              None if self.bias is None
                              else self.bias.to(device))

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        out = x @ self.L
        if self.bias is not None:
            out = out + self.bias[None, :].to(out.dtype)
        return out

    def compose(self, other: "LinearOperator") -> "LinearOperator":
        """Associativity: (X L₁) L₂ = X (L₁ L₂) — pre-fold chained layers."""
        bias = None
        if self.bias is not None:
            bias = self.bias @ other.L
        if other.bias is not None:
            bias = other.bias if bias is None else bias + other.bias
        return LinearOperator(self.L @ other.L, bias)


@dataclasses.dataclass(frozen=True)
class DecisionTreeGEMM:
    """Hummingbird GEMM decision tree: ((X F > v) H) == h."""

    F: torch.Tensor  # (k, p) {0,1} feature selection, one 1 per column
    v: torch.Tensor  # (p,) node thresholds
    H: torch.Tensor  # (p, l) {−1,0,1} leaf paths
    h: torch.Tensor  # (l,) positive-entry count per column of H

    @property
    def k(self) -> int:
        return int(self.F.shape[0])

    @property
    def p(self) -> int:
        return int(self.F.shape[1])

    @property
    def l(self) -> int:
        return int(self.H.shape[1])

    def to(self, device) -> "DecisionTreeGEMM":
        return DecisionTreeGEMM(self.F.to(device), self.v.to(device),
                                self.H.to(device), self.h.to(device))

    def predicates(self, x: torch.Tensor) -> torch.Tensor:
        """Step 1–2: (X F > v) ∈ {0,1}^{i×p}."""
        return (x @ self.F > self.v[None, :]).to(x.dtype)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """One-hot leaf encoding (i × l) — steps 1–4 of Fig. 5."""
        score = self.predicates(x) @ self.H.to(x.dtype)
        return (score == self.h[None, :].to(x.dtype)).to(x.dtype)

    def predict_leaf(self, x: torch.Tensor) -> torch.Tensor:
        """Leaf index per row (argmax over the one-hot encoding)."""
        return torch.argmax(self.apply(x), dim=1)


def tree_from_arrays(feature: np.ndarray, threshold: np.ndarray, k: int
                     ) -> DecisionTreeGEMM:
    """Build the GEMM form of a *complete* binary tree (on the host).

    ``feature[n]``/``threshold[n]`` describe internal node n in level order;
    leaves are the 2^depth paths.
    """
    p = int(feature.shape[0])
    depth = int(np.log2(p + 1))
    l = p + 1
    F = np.zeros((k, p), np.float32)
    F[feature, np.arange(p)] = 1.0
    H = np.zeros((p, l), np.float32)
    for leaf in range(l):
        node = 0
        for level in range(depth):
            go_right = (leaf >> (depth - 1 - level)) & 1
            H[node, leaf] = 1.0 if go_right else -1.0
            node = 2 * node + 1 + go_right
    h = np.maximum(H, 0.0).sum(axis=0)
    return DecisionTreeGEMM(torch.from_numpy(F),
                            torch.from_numpy(np.asarray(threshold,
                                                        np.float32)),
                            torch.from_numpy(H),
                            torch.from_numpy(h.astype(np.float32)))


def random_tree(rng: np.random.Generator, k: int, depth: int,
                scale: float = 1.0) -> DecisionTreeGEMM:
    """A random complete tree over k features (same draws as the reference)."""
    p = 2**depth - 1
    feature = rng.integers(0, k, size=p)
    threshold = rng.normal(0.0, scale, size=p).astype(np.float32)
    return tree_from_arrays(feature, threshold, k)


def reference_tree_eval(feature: np.ndarray, threshold: np.ndarray,
                        x: np.ndarray) -> np.ndarray:
    """Direct (non-LA) tree traversal oracle: leaf index per row."""
    p = feature.shape[0]
    depth = int(np.log2(p + 1))
    out = np.zeros((x.shape[0],), np.int64)
    for r in range(x.shape[0]):
        node = 0
        leaf = 0
        for _ in range(depth):
            right = x[r, feature[node]] > threshold[node]
            leaf = (leaf << 1) | int(right)
            node = 2 * node + 1 + int(right)
        out[r] = leaf
    return out
