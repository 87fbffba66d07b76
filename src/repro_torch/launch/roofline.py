"""Roofline terms for a traced (arch × shape × mesh) cell (port of
``repro.launch.roofline``).

Hardware model: one NVIDIA H100 SXM5 (``nvidia-smi --query-gpu=name,
power.limit --format=csv,noheader`` gives ``NVIDIA H100 80GB HBM3,
700.00 W`` on the card these figures are for; a card capped below 700 W
runs slower under load):

  peak compute   989 TFLOP/s dense bf16 per GPU (NVIDIA H100 datasheet,
                 SXM, without sparsity)
  HBM bandwidth  3.35 TB/s HBM3 per GPU (same datasheet)
  collective     50 GB/s per GPU per direction: one 400 Gb/s ConnectX-7
                 InfiniBand port per GPU (NVIDIA DGX H100 datasheet).  A
                 16-wide mesh axis spans two 8-GPU NVLink nodes, so its
                 rings cross this inter-node link, the slowest on the
                 path; an axis inside one node would run on NVLink 4
                 (900 GB/s per GPU, both directions together).

Terms (all per-device; the traced costs are per-device — see
hlo_analysis.py — so the device count cancels):

  compute    = flops / peak_FLOPs
  memory     = mem_bytes / HBM_bw
  collective = collective_bytes / link_bw

MODEL_FLOPS = 6·N·D for training (2·N·D inference), N = active params,
D = tokens processed; the ratio MODEL_FLOPS / traced flops exposes remat /
redundant-compute waste.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..models import ModelConfig
from .hlo_analysis import Costs
from .steps import SHAPES

PEAK_FLOPS = 989e12          # bf16 dense / GPU
HBM_BW = 3.35e12             # B/s / GPU
ICI_BW = 50e9                # B/s / GPU, the inter-node link (docstring)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_dev: float
    mem_bytes_per_dev: float
    coll_bytes_per_dev: float
    wire_bytes_per_dev: float
    n_collectives: float
    coll_by_kind: Dict[str, float]
    model_flops_total: float

    @property
    def t_compute(self) -> float:
        return self.flops_per_dev / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.mem_bytes_per_dev / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_dev / ICI_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def model_flops_per_dev(self) -> float:
        return self.model_flops_total / max(self.n_devices, 1)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / traced flops (per device): <1 ⇒ remat /
        redundancy / non-model compute."""
        return self.model_flops_per_dev / max(self.flops_per_dev, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs throughput vs peak if the dominant term were the
        only cost: MODEL_FLOPS/(devices·peak) ÷ max(term)."""
        denom = max(self.t_compute, self.t_memory, self.t_collective)
        ideal = self.model_flops_per_dev / PEAK_FLOPS
        return ideal / max(denom, 1e-30)

    def to_json(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "n_devices": self.n_devices,
            "flops_per_dev": self.flops_per_dev,
            "mem_bytes_per_dev": self.mem_bytes_per_dev,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "wire_bytes_per_dev": self.wire_bytes_per_dev,
            "n_collectives": self.n_collectives,
            "coll_by_kind": self.coll_by_kind,
            "model_flops_total": self.model_flops_total,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(cfg: ModelConfig, shape: str) -> float:
    """Analytic model FLOPs for one step of this cell (all devices)."""
    info = SHAPES[shape]
    n_active = cfg.active_params()
    if info["kind"] == "train":
        tokens = info["batch"] * info["seq"]
        flops = 6.0 * n_active * tokens
        # Attention score/value FLOPs (not in 6ND): 12·L_attn·d_head·H·S²·B/2.
        n_attn = sum(1 for s in cfg.pattern
                     if s.mixer == "attn") * cfg.n_repeats
        flops += 6.0 * n_attn * cfg.n_heads * cfg.hd * info["seq"] \
            * tokens
        return flops
    if info["kind"] == "prefill":
        tokens = info["batch"] * info["seq"]
        n_attn = sum(1 for s in cfg.pattern
                     if s.mixer == "attn") * cfg.n_repeats
        return 2.0 * n_active * tokens + 2.0 * n_attn * cfg.n_heads * \
            cfg.hd * info["seq"] * tokens
    # decode: one token per sequence + attention over the KV cache.
    tokens = info["batch"]
    n_attn = sum(1 for s in cfg.pattern if s.mixer == "attn") * cfg.n_repeats
    return (2.0 * n_active * tokens
            + 4.0 * n_attn * cfg.n_kv_heads * cfg.hd * info["seq"] * tokens)


def analyze_cell(arch: str, shape: str, mesh_name: str, n_devices: int,
                 cfg: ModelConfig, costs: Costs) -> Roofline:
    """The cell's roofline from its traced per-device ``costs``."""
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        flops_per_dev=costs.flops,
        mem_bytes_per_dev=costs.mem_bytes,
        coll_bytes_per_dev=costs.total_coll_bytes,
        wire_bytes_per_dev=costs.wire_bytes,
        n_collectives=costs.n_collectives,
        coll_by_kind=dict(costs.coll_bytes),
        model_flops_total=model_flops(cfg, shape))
