"""Placement rules over a mesh: ``PartitionSpec`` and the divisibility
fallback (the serving part of ``repro.launch.sharding``).

A spec names, per tensor dimension, the mesh axis (or tuple of axes) it
is split over, ``None`` for a dimension every position holds whole.  A
dimension that does not divide its axes is left whole instead of failing
(``safe_spec``): the reference's 15-heads-on-16-way rule, which the
placement planner applies to prefused partials' row counts.

The reference's parameter, batch and cache specs (``param_pspec``,
``param_shardings``, ``batch_pspec``, ``cache_pspec``) belong to the LM
scaffold, which is not ported yet.
"""
from __future__ import annotations


class PartitionSpec(tuple):
    """Per-dimension mesh axes of a placed tensor (``None``: whole).

    A tuple, so it compares equal to jax's ``PartitionSpec`` of the same
    entries and to a plain tuple.
    """

    def __new__(cls, *partitions):
        return super().__new__(cls, partitions)


P = PartitionSpec


def _div(mesh, dim: int, axis) -> bool:
    if axis is None:
        return True
    axes = (axis,) if isinstance(axis, str) else axis
    total = 1
    for a in axes:
        if a not in mesh.axis_names:
            return False
        total *= mesh.shape[a]
    return dim % total == 0


def safe_spec(mesh, shape, *axes) -> PartitionSpec:
    """PartitionSpec with the divisibility fallback per dimension."""
    return P(*[a if _div(mesh, d, a) else None
               for d, a in zip(shape, axes)])
