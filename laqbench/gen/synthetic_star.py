"""The paper's synthetic star (arXiv 2306.08367, Table 4), on the device.

Three dimensions ``dim_b``, ``dim_c``, ``dim_d`` with N(0, 1) float32
feature columns ``b0…``, ``c0…``, ``d0…`` (the widths the configuration
gives) and a dense key ``pk``; a fact table ``fact`` of uniform foreign
keys ``fk_b``, ``fk_c``, ``fk_d``.  As ``repro_torch/data/synthetic.py``
lays it out, drawn with a ``torch.Generator`` in one call per table.
"""
from __future__ import annotations

import torch

from . import RawTable, rows

DIMS = ("b", "c", "d")


def generate(config, g, dev, scale):
    tables, n_dim = {}, {}
    for name, width in zip(DIMS, config["feature_widths"]):
        n = rows(config, f"dim_{name}", scale)
        feats = torch.randn((width, n), generator=g, device=dev,
                            dtype=torch.float32)
        cols = {f"{name}{j}": feats[j] for j in range(width)}
        cols["pk"] = torch.arange(n, device=dev, dtype=torch.int32)
        tables[f"dim_{name}"] = RawTable(cols, ("pk",))
        n_dim[name] = n
    n_fact = rows(config, "fact", scale)
    fks = {f"fk_{name}": torch.randint(0, n_dim[name], (n_fact,),
                                       generator=g, device=dev,
                                       dtype=torch.int32)
           for name in DIMS}
    tables["fact"] = RawTable(fks, tuple(fks))
    return tables
