"""Activation sharding constraints (port of ``repro.models.act_sharding``).

Model code calls ``constrain(x, "dp", None, "tp")`` with logical axis roles,
as the reference's does.  The port does not shard the LM yet (the LM part
of ``launch/sharding.py`` is still to be ported), so ``constrain`` is the
identity: ``set_activation_sharding`` records the roles' axes and nothing
places a tensor by them.  The reference's ``constrain`` is a no-op too
outside a mesh context, which is how its CPU tests and examples run.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

_CTX = {"dp": None, "tp": None, "mesh": None}


def set_activation_sharding(dp_axes: Optional[Tuple[str, ...]],
                            tp_axis: Optional[str], mesh=None):
    _CTX["dp"] = tuple(dp_axes) if dp_axes else None
    _CTX["tp"] = tp_axis
    _CTX["mesh"] = mesh


def clear_activation_sharding():
    set_activation_sharding(None, None, None)


def constrain(x: torch.Tensor, *roles) -> torch.Tensor:
    """The identity until the LM is sharded (see the module docstring)."""
    return x
