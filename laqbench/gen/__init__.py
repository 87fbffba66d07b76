"""Data generators: ``gen/<generator>.py`` makes a configuration's tables
on a device from a seed, as :class:`RawTable` columns."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

import torch


@dataclasses.dataclass
class RawTable:
    """One generated relation: ordered columns (int32 or float32) and the
    names of its exact integer key columns."""

    columns: Dict[str, torch.Tensor]
    keys: Tuple[str, ...]

    @property
    def n(self) -> int:
        return int(next(iter(self.columns.values())).shape[0])


def to_host(raw: Dict[str, RawTable]) -> Dict[str, RawTable]:
    """The same tables with numpy columns in host memory."""
    return {name: RawTable({c: t.cpu().numpy()
                            for c, t in rt.columns.items()}, rt.keys)
            for name, rt in raw.items()}


def generate(config: dict, seed: int, device, scale: float = 1.0
             ) -> Dict[str, RawTable]:
    """The tables of ``config`` drawn from ``seed`` on ``device``.

    ``scale`` shrinks every row count (tests only; the benchmark runs at 1).
    """
    mod = importlib.import_module(f"{__name__}.{config['generator']}")
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2**63))
    return mod.generate(config, g, torch.device(device), scale)


def rows(config: dict, table: str, scale: float, least: int = 8) -> int:
    return max(int(config["rows"][table] * scale), least)
