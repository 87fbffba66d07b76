"""MM-Join: equi-join as (sparse) matrix multiplication (port of
``repro.core.laq.join``).

* ``mmjoin_dense`` — paper-faithful Alg. 1: one-hot key matrices over the
  common key domain, ``I = MAT_R @ MAT_Sᵀ``.
* ``mmjoin_bcoo`` — the same contraction with MAT_R as a sparse COO
  tensor (the reference's BCOO spMM, the paper's cuSPARSE path).
* ``join_factored`` — the form used at scale: for PK–FK joins the matching
  matrix has at most one nonzero per fact row, so it is kept factored as an
  int32 pointer vector with ``I = onehot(ptr)``; applying I is a gather.

Materialization (paper §2.3.3) is given both as explicit row-mapping
matrices ``I_R, I_S`` (``materialize_matmul``) and as gathers
(``materialize_gather``), from the COO pairs of a row-matching matrix
(``matching_pairs``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from .domain import key_domain, positions
from .table import PAD_KEY, Table


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


def mmjoin_bcoo(keys_r: torch.Tensor, keys_s: torch.Tensor,
                domain_size: int) -> torch.Tensor:
    """Faithful sparse path: a sparse COO MAT_R times dense MAT_Sᵀ.

    Each one-hot matrix has one entry per row, at ``(row, min(pos, |dom|-1))``
    with value 1 where the key is in the domain and 0 where it is not —
    the reference's BCOO indices, values and shape.  The product is dense,
    as the reference's ``bcoo_dot_general`` with a dense operand is.
    """
    dom = key_domain([keys_r, keys_s], domain_size)
    n_dom = int(dom.shape[0])

    def to_coo(keys):
        pos = positions(dom, keys)
        rows = torch.arange(keys.shape[0], dtype=torch.int64,
                            device=keys.device)
        idx = torch.stack([rows, pos.clamp(max=n_dom - 1).to(torch.int64)])
        vals = (pos < n_dom).to(torch.float32)
        return torch.sparse_coo_tensor(idx, vals, (keys.shape[0], n_dom),
                                       device=keys.device,
                                       check_invariants=True).coalesce()

    mat_r = to_coo(keys_r)
    mat_s = to_coo(keys_s).to_dense()
    return torch.sparse.mm(mat_r, mat_s.T.contiguous())


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

    @property
    def n_live(self) -> int:
        """Number of live (non-PAD_KEY) keys in the index."""
        return _count_below_pad(self.sorted_pk)

    def extend(self, new_keys, new_row_ids) -> "PKIndex":
        """Sorted-merge appended ``(key, row)`` pairs into the index.

        The incremental half of the Catalog append path: the m appended
        keys are sorted alone and merged into the live prefix through two
        searchsorteds (O(r + m log m)) instead of re-sorting all
        ``capacity`` rows.  The result is array-identical to ``pk_index``
        over the appended table — including the PAD_KEY tail, whose stable
        argsort order is the remaining pad row ids ascending — so probes
        through an extended index are the cold rebuild's bit for bit.
        ``new_row_ids`` must be the table's next contiguous row block (the
        Catalog append invariant).  Every step is a tensor operation on the
        index's device.
        """
        sp, od = self.sorted_pk, self.order
        dev = sp.device
        cap = int(sp.shape[0])
        n_old = _count_below_pad(sp)
        nk = torch.as_tensor(new_keys).to(device=dev,
                                          dtype=torch.int32).reshape(-1)
        nr = torch.as_tensor(new_row_ids).to(device=dev,
                                             dtype=torch.int32).reshape(-1)
        if nk.shape[0] != nr.shape[0]:
            raise ValueError(
                f"extend: {nk.shape[0]} keys vs {nr.shape[0]} row ids")
        live = nk != PAD_KEY
        nk, nr = nk[live], nr[live]
        m = int(nk.shape[0])
        if n_old + m > cap:
            raise ValueError(
                f"extend: {n_old} live + {m} appended keys exceed index "
                f"capacity {cap} — rebuild with pk_index after growing")
        perm = torch.argsort(nk, stable=True)
        nk, nr = nk[perm], nr[perm]
        if bool((nk[1:] == nk[:-1]).any()):
            raise ValueError("extend: duplicate keys within the appended "
                             "block violate PK uniqueness")
        old = sp[:n_old]
        ins = torch.searchsorted(old, nk)
        if n_old:
            dup = old[ins.clamp(max=n_old - 1)] == nk
            if bool(dup.any()):
                raise ValueError(
                    f"extend: appended keys {nk[dup][:8].tolist()} already "
                    "exist in the index (PK uniqueness)")
        n_new = n_old + m
        new_pos = ins + torch.arange(m, device=dev)
        old_pos = (torch.arange(n_old, device=dev)
                   + torch.searchsorted(nk, old))
        out_pk = torch.full((cap,), PAD_KEY, dtype=torch.int32, device=dev)
        out_od = torch.empty((cap,), dtype=torch.int32, device=dev)
        out_pk[old_pos] = old
        out_od[old_pos] = od[:n_old]
        out_pk[new_pos] = nk
        out_od[new_pos] = nr
        # Stable-argsort pad tail: the remaining pad rows, ascending.
        out_od[n_new:] = torch.arange(n_new, cap, dtype=torch.int32,
                                      device=dev)
        return PKIndex(sorted_pk=out_pk, order=out_od)


def _count_below_pad(sorted_pk: torch.Tensor) -> int:
    """How many entries of an ascending key array sort before PAD_KEY."""
    pad = torch.full((1,), PAD_KEY, dtype=sorted_pk.dtype,
                     device=sorted_pk.device)
    return int(torch.searchsorted(sorted_pk, pad)[0])


def pk_index(pk: torch.Tensor) -> PKIndex:
    """Sort the PK side once; live keys must be unique.

    The argsort is explicitly stable, as ``jnp.argsort`` is by default, so
    the PAD_KEY tail orders its rows ascending exactly as the reference's.
    """
    order = torch.argsort(pk, stable=True).to(torch.int32)
    return PKIndex(sorted_pk=pk[order], order=order)


@dataclasses.dataclass(frozen=True)
class ShardedPKIndex:
    """Row-sharded ``PKIndex``: one independent index slice per shard.

    Shard ``s`` owns the contiguous dimension rows ``[s·rps, (s+1)·rps)``
    and indexes only those: ``order`` holds shard-local row offsets, so a
    probe against one slice resolves to shard-local rows.  A key another
    shard owns misses; at most one shard hits a live key (live PKs are
    unique), so combining the per-shard ``found`` masks gives the global
    probe.
    """

    sorted_pk: torch.Tensor   # (num_shards, rows_per_shard), ascending rows
    order: torch.Tensor       # (num_shards, rows_per_shard) int32, local

    @property
    def num_shards(self) -> int:
        return int(self.sorted_pk.shape[0])

    @property
    def rows_per_shard(self) -> int:
        return int(self.sorted_pk.shape[1])

    def shard(self, s: int) -> PKIndex:
        """The shard-local ``PKIndex`` slice."""
        return PKIndex(sorted_pk=self.sorted_pk[s], order=self.order[s])


def shard_pk_index(pk: torch.Tensor, num_shards: int) -> ShardedPKIndex:
    """Per-shard ``PKIndex`` slices over equal contiguous row blocks.

    The row count must divide ``num_shards`` (the placement planner's
    ``safe_spec`` fallback replicates the tables that do not).  Each block
    is argsorted stably, as ``pk_index`` sorts, on ``pk``'s device.
    """
    r = int(pk.shape[0])
    if num_shards < 1 or r % num_shards:
        raise ValueError(
            f"cannot shard {r} PK rows into {num_shards} equal slices")
    blocks = pk.reshape(num_shards, r // num_shards)
    order = torch.argsort(blocks, dim=1, stable=True).to(torch.int32)
    return ShardedPKIndex(
        sorted_pk=torch.gather(blocks, 1, order.to(torch.int64)),
        order=order)


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


# --------------------------------------------------------------------------
# Materialization (paper §2.3.3)
# --------------------------------------------------------------------------
def _take_fill(x: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """``jnp.take(x, idx, axis=0, mode="fill", fill_value=fill)``: ids
    outside ``[0, n)`` (negative ones too) read ``fill``."""
    n = x.shape[0]
    inside = (idx >= 0) & (idx < n)
    out = x[idx.clamp(0, max(n - 1, 0)).to(torch.int64)]
    inside = inside.reshape(inside.shape + (1,) * (out.dim() - 1))
    return torch.where(inside, out, torch.full((), fill, dtype=x.dtype,
                                               device=x.device))


def matching_pairs(I: torch.Tensor, capacity: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """COO of the row-matching matrix, padded to ``capacity``.

    Returns (rows_R, rows_S, nnz) in row-major order; padded entries point
    at ``max(I.shape)`` so downstream fill-gathers yield zero rows.
    """
    hit = I > 0
    nz = torch.nonzero(hit)[:capacity].to(torch.int32)
    fill = max(int(I.shape[0]), int(I.shape[1]))
    ii = torch.full((capacity,), fill, dtype=torch.int32, device=I.device)
    jj = torch.full((capacity,), fill, dtype=torch.int32, device=I.device)
    ii[:nz.shape[0]] = nz[:, 0]
    jj[:nz.shape[0]] = nz[:, 1]
    return ii, jj, hit.sum(dtype=torch.int32)


def row_mapping_matrices(ii: torch.Tensor, jj: torch.Tensor, r_rows: int,
                         s_rows: int, dtype=torch.float32):
    """Faithful I_R, I_S: target row m comes from R row ii[m] / S row jj[m]."""
    i_r = (ii[:, None] == torch.arange(r_rows, device=ii.device)[None, :])
    i_s = (jj[:, None] == torch.arange(s_rows, device=jj.device)[None, :])
    return i_r.to(dtype), i_s.to(dtype)


def _joined_table(r: Table, s: Table, ii, jj, nnz, left, right) -> Table:
    cols = tuple(f"{r.name}.{c}" for c in r.columns) + tuple(
        f"{s.name}.{c}" for c in s.columns)
    keys = {}
    for src, idx in ((r, ii), (s, jj)):
        for c, v in src.keys.items():
            keys[f"{src.name}.{c}"] = _take_fill(v, idx, PAD_KEY)
    return Table(f"{r.name}_join_{s.name}", cols,
                 torch.cat([left, right], dim=1), keys, int(nnz))


def materialize_matmul(I: torch.Tensor, r: Table, s: Table, capacity: int
                       ) -> Table:
    """Paper-faithful materialization: T = [I_R @ R.matrix | I_S @ S.matrix]."""
    ii, jj, nnz = matching_pairs(I, capacity)
    i_r, i_s = row_mapping_matrices(ii, jj, r.capacity, s.capacity)
    return _joined_table(r, s, ii, jj, nnz, i_r @ r.matrix, i_s @ s.matrix)


def materialize_gather(I: torch.Tensor, r: Table, s: Table, capacity: int
                       ) -> Table:
    """Optimized materialization: gathers instead of one-hot matmuls."""
    ii, jj, nnz = matching_pairs(I, capacity)
    return _joined_table(r, s, ii, jj, nnz, _take_fill(r.matrix, ii, 0.0),
                         _take_fill(s.matrix, jj, 0.0))
