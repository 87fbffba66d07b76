"""AdamW optimizer (port of ``repro.optim.adamw``): functional, over trees
of tensors.

* Optimizer state dtype is configurable (fp32 default, bf16 for the
  biggest configs — halves the moments' memory).
* Global-norm clipping and decoupled weight decay built in.
* ``adamw_update`` returns new tensors and writes none it is given, as the
  reference's does; call it under ``torch.no_grad()``.

The arithmetic is the reference's, in its order: fp32 moments, the bias
corrections ``1 - b**step`` on an fp32 step, ``p - lr·(m̂/(√v̂+eps) +
wd·p)`` in fp32 cast back to the parameter's dtype.  ``global_norm`` sums
the leaves' fp32 squares in the reference's leaf order (sorted dict keys,
:mod:`repro_torch.tree`), so the clip scale is the same number up to the
rounding of each leaf's own sum.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from ..tree import leaves, tree_map, unflatten

class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: Optional[str] = None  # None → fp32


def global_norm(tree) -> torch.Tensor:
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), norm


def adamw_init(params, cfg: AdamWConfig) -> AdamWState:
    dt = getattr(torch, cfg.state_dtype) if cfg.state_dtype else torch.float32
    first = leaves(params)[0]

    def zeros(p):            # a DTensor's moments are born on its placements
        return torch.zeros_like(p, dtype=dt)

    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=first.device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def adamw_update(params, grads, state: AdamWState, cfg: AdamWConfig,
                 lr_scale: torch.Tensor | float = 1.0):
    """One AdamW step; returns (new_params, new_state, metrics)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v):
        gf = g.to(torch.float32)
        m_new = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * gf
        v_new = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * gf * gf
        mh = m_new / b1c
        vh = v_new / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * \
            p.to(torch.float32)
        p_new = p.to(torch.float32) - lr * delta
        return (p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype))

    triples = [upd(*x) for x in zip(leaves(params), leaves(grads),
                                    leaves(state.m), leaves(state.v))]

    def part(i):
        return unflatten(params, [t[i] for t in triples])

    metrics = {"grad_norm": gnorm,
               "lr": torch.as_tensor(lr, dtype=torch.float32,
                                     device=gnorm.device)}
    return part(0), AdamWState(step, part(1), part(2)), metrics
