"""Synthetic star schema for the operator-fusion experiments (paper Table 4),
port of ``repro.data.synthetic``.

  setting 1: lineorder sf·600,000; part 20,000·⌊1+log2 sf⌋; supplier sf·2,000;
             date 7·365   — "large input, small model"
  setting 2: lineorder sf·3,000;   part  2,000·⌊1+log2 sf⌋; supplier sf·2,000;
             date 7·365   — "small input, large model"
Feature columns split evenly across the three dimension tables (c = k/3),
filled with N(0,1) floats from the same numpy draws as the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from ..core.laq import DimSpec, StarJoin, Table, star_join
from ..device import DeviceLike, resolve_device


@dataclasses.dataclass
class SyntheticStar:
    star: StarJoin
    k: int               # total feature columns
    n_fact: int
    dim_rows: Tuple[int, int, int]


def cardinalities(setting: int, sf: float):
    logf = math.floor(1 + math.log2(max(sf, 1)))
    if setting == 1:
        return (int(sf * 600_000), int(20_000 * logf), int(sf * 2_000),
                7 * 365)
    return (int(sf * 3_000), int(2_000 * logf), int(sf * 2_000), 7 * 365)


def generate(setting: int, sf: float, k: int, seed: int = 0,
             scale: float = 1.0, device: DeviceLike = None) -> SyntheticStar:
    """Build the star join for cardinality ``setting`` with k features."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_fact, n_b, n_c, n_d = [max(int(n * scale), 8)
                             for n in cardinalities(setting, sf)]
    c = k // 3
    widths = [c, c, k - 2 * c]
    specs = []
    for name, n_rows, width in zip("bcd", (n_b, n_c, n_d), widths):
        cols = {f"{name}{j}": rng.normal(size=n_rows).astype(np.float32)
                for j in range(width)}
        cols["pk"] = np.arange(n_rows)
        dim = Table.from_columns(f"dim_{name}", cols, key_cols=("pk",),
                                 device=dev)
        specs.append((dim, n_rows, tuple(f"{name}{j}" for j in range(width))))

    fact_cols = {
        f"fk_{name}": rng.integers(0, n_rows, n_fact)
        for (dim, n_rows, _), name in zip(specs, "bcd")
    }
    fact = Table.from_columns("fact", fact_cols,
                              key_cols=tuple(fact_cols.keys()), device=dev)
    dim_specs = [DimSpec(dim, f"fk_{name}", "pk", feats)
                 for (dim, _, feats), name in zip(specs, "bcd")]
    return SyntheticStar(star=star_join(fact, dim_specs), k=k,
                         n_fact=n_fact,
                         dim_rows=(specs[0][1], specs[1][1], specs[2][1]))
