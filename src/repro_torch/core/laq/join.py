"""MM-Join: equi-join as (sparse) matrix multiplication (port of
``repro.core.laq.join``).

* ``mmjoin_dense`` — paper-faithful Alg. 1: one-hot key matrices over the
  common key domain, ``I = MAT_R @ MAT_Sᵀ``.
* ``join_factored`` — the form used at scale: for PK–FK joins the matching
  matrix has at most one nonzero per fact row, so it is kept factored as an
  int32 pointer vector with ``I = onehot(ptr)``; applying I is a gather.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from .domain import key_domain, positions
from .table import PAD_KEY


def onehot_keys(keys: torch.Tensor, domain: torch.Tensor,
                dtype=torch.float32) -> torch.Tensor:
    """MAT ∈ {0,1}^{rows × |domain|}; all-zero row for padded/missing keys."""
    pos = positions(domain, keys)
    slots = torch.arange(domain.shape[0], device=keys.device)
    return (pos[:, None] == slots[None, :]).to(dtype)


def mmjoin_dense(keys_r: torch.Tensor, keys_s: torch.Tensor,
                 domain_size: int) -> torch.Tensor:
    """Row-matching matrix I[i,j] = 1 iff keys_r[i] == keys_s[j] (Alg. 1)."""
    dom = key_domain([keys_r, keys_s], domain_size)
    return onehot_keys(keys_r, dom) @ onehot_keys(keys_s, dom).T


@dataclasses.dataclass(frozen=True)
class FactoredJoin:
    """I = onehot(ptr) with a validity mask, never materialized.

    ptr[i]   = row of the PK-side relation matching FK row i (0 on a miss).
    found[i] = FK row i has a live match.
    """

    ptr: torch.Tensor    # (r_fk,) int32
    found: torch.Tensor  # (r_fk,) bool

    def apply(self, pk_matrix: torch.Tensor) -> torch.Tensor:
        """I @ pk_matrix as a gather (zero rows where no match).

        The liveness multiplies rather than selects, so a NaN row stays NaN
        where it misses — as the reference's gather-and-multiply does.
        """
        rows = pk_matrix.index_select(0, self.ptr)
        return rows * self.found[:, None].to(pk_matrix.dtype)

    def dense(self, pk_rows: int, dtype=torch.float32) -> torch.Tensor:
        """Materialize I (tests / faithful comparisons only)."""
        cols = torch.arange(pk_rows, device=self.ptr.device)
        oh = (self.ptr[:, None] == cols[None, :]).to(dtype)
        return oh * self.found[:, None].to(dtype)


@dataclasses.dataclass(frozen=True)
class PKIndex:
    """Sorted primary-key index: the quasi-static half of ``join_factored``."""

    sorted_pk: torch.Tensor   # ascending (PAD_KEY sorts last)
    order: torch.Tensor       # int32 stable argsort permutation

    def probe(self, fk: torch.Tensor) -> FactoredJoin:
        # right=False is jnp.searchsorted's default 'left' side.
        pos = torch.searchsorted(self.sorted_pk, fk, out_int32=True)
        pos_c = pos.clamp(0, self.sorted_pk.shape[0] - 1)
        hit = (self.sorted_pk[pos_c] == fk) & (fk != PAD_KEY)
        ptr = self.order[pos_c]
        return FactoredJoin(ptr=torch.where(hit, ptr, torch.zeros_like(ptr)),
                            found=hit)


def pk_index(pk: torch.Tensor) -> PKIndex:
    """Sort the PK side once; live keys must be unique.

    The argsort is explicitly stable, as ``jnp.argsort`` is by default, so
    the PAD_KEY tail orders its rows ascending exactly as the reference's.
    """
    order = torch.argsort(pk, stable=True).to(torch.int32)
    return PKIndex(sorted_pk=pk[order], order=order)


def join_factored(fk: torch.Tensor, pk: torch.Tensor) -> FactoredJoin:
    """PK-FK equi-join: pointer from each FK row into the PK relation."""
    return pk_index(pk).probe(fk)


def stack_joins(joins: Sequence[FactoredJoin]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-arm pointers and liveness stacked as ``(J, n)`` int32 / bool.

    The layout ``fused_star_gather`` reads; a compiled query stacks once and
    keeps the per-arm joins as row views of these tensors.
    """
    ptrs = torch.stack([fj.ptr for fj in joins]).to(torch.int32)
    founds = torch.stack([fj.found for fj in joins]).to(torch.bool)
    return ptrs.contiguous(), founds.contiguous()
