"""Model heads of the query specs, drawn on the host from a fixed seed.

A spec ``{"kind": "linear", "k", "l", "seed"}`` or ``{"kind": "tree",
"k", "depth", "seed"}`` gives the same arrays as the registry of
``repro_torch/data/ssb_queries.py`` and ``random_tree`` of
``repro_torch/core/fusion``: a fixed seed per query keeps the plan, and so
the work, the same from run to run.  Both sides take these arrays: the
program in its GEMM form, the reference as weights or as nodes to walk.
"""
from __future__ import annotations

import numpy as np


def draw(mspec: dict, k: int) -> dict:
    """The head's parameters: ``L`` (k, l) float32, or a complete tree's
    level-order ``feature`` (p,) int64 and ``threshold`` (p,) float32."""
    if mspec["k"] != k:
        raise ValueError(f"model k={mspec['k']} but the query feeds {k} "
                         "features")
    rng = np.random.default_rng(mspec["seed"])
    if mspec["kind"] == "linear":
        L = rng.normal(size=(k, mspec["l"])).astype(np.float32) / np.sqrt(k)
        return {"kind": "linear", "L": np.asarray(L, np.float32)}
    if mspec["kind"] == "tree":
        p = 2 ** mspec["depth"] - 1
        feature = rng.integers(0, k, size=p)
        threshold = rng.normal(0.0, 1.0, size=p).astype(np.float32)
        return {"kind": "tree", "depth": mspec["depth"],
                "feature": feature, "threshold": threshold}
    raise ValueError(f"unknown model kind {mspec['kind']!r}")


def width(model: dict) -> int:
    """Output columns ``l``: the linear head's width, a tree's leaves."""
    if model["kind"] == "linear":
        return int(model["L"].shape[1])
    return 2 ** model["depth"]
