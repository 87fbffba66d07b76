"""LR schedules: linear warmup + {cosine, linear, constant} decay (port of
``repro.optim.schedule``).  Each returns a 0-d fp32 tensor (on ``step``'s
device when ``step`` is a tensor)."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def warmup_cosine(step, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    step = _step(step)
    warm = step / max(warmup_steps, 1)
    prog = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, cos)


def warmup_linear(step, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.0):
    step = _step(step)
    warm = step / max(warmup_steps, 1)
    prog = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    lin = 1.0 - (1.0 - min_ratio) * torch.clamp(prog, 0.0, 1.0)
    return torch.where(step < warmup_steps, warm, lin)


def constant(step, warmup_steps: int = 0, **_):
    step = _step(step)
    return torch.clamp(step / max(warmup_steps, 1), max=1.0)
