"""Sharded prefused partials: Eq. 1's quasi-static state over a device mesh
(port of ``repro.core.query.sharding``).

The paper's serving speedup rests on prefusing each dimension's partial
``P_j = B_j M_j L`` offline and serving queries as gathers over those
partials.  At production scale the partials outgrow one device, so this
module partitions the serving state over a
:class:`~repro_torch.launch.mesh.Mesh` of ``torch.device``s:

* **Partials row-shard** over the mesh's ``model`` axis in contiguous
  blocks, each block paired with its own ``ShardedPKIndex`` slice and
  dimension-predicate mask, so a probe + gather reads only its shard's
  rows.  A key another shard owns misses locally; at most one shard hits a
  key (live PKs are unique), so summing the per-shard ``(part, hit count)``
  pairs over the model axis rebuilds the global gather.
* **Request batches split** over the data-parallel axes; the model tail
  (the tree's compare vector ``h``, a nonfused head) is replicated.
* **Placement is planned** (``planner.plan_partition_spec``): tables below
  a byte threshold replicate, larger ones row-shard through
  ``launch.sharding.safe_spec``, and a row count that does not divide the
  axis replicates.

One process drives the whole mesh: the reference's ``shard_map`` becomes a
loop over data-parallel rows and model shards, each shard's probe and
gather issued on that shard's device, and the reference's ``psum`` a sum,
in shard order, of the shard contributions on the row's merge device (its
shard 0).  A placed tensor (:class:`Placed`) holds one tensor per distinct
device and block: on a virtual mesh (every position one device) a
row-sharded table's blocks are views of one tensor and a replicated one is
held once, so an 8-shard mesh on one card costs no more device memory than
the single-device runtime.

Bit-exactness: the owning shard contributes the fp32 row the single-device
gather reads and every other shard zeros, and the merged parts go through
the single-device runtime's arm and operation order (``_accumulate``), so
sharded ``serve`` equals the port's single-device plain path.  The one
exception is a nonfused linear head: its matmul runs per data-parallel row,
and a matmul's rounding depends on the batch shape (1 ulp).  Sharded
``predict_rows`` keeps the port's single-device fill rules for ids outside
the fact table (NaN rows for linear heads, zero rows for fused trees, the
all-false leaf for nonfused trees): the reference's sharded forward writes
NaN rows for every head there, where its own single-device path does not.

No kernel runs here, as the reference composes no Pallas kernel with its
``shard_map``: ``planner.resolve_mesh_serve_backend`` resolves a mesh to the
plain gathers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from ...launch.mesh import device_grid
from ...launch.sharding import P
from ..fusion.operators import DecisionTreeGEMM, LinearOperator
from ..laq.join import PKIndex, pk_index, shard_pk_index


def _is_sharded(spec) -> bool:
    return len(spec) > 0 and spec[0] is not None


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(x, idx, axis=0)`` with its default fill rules.

    Negative ids wrap once; ids still outside ``[0, n)`` read the fill
    value: NaN for floats, the type's minimum for ints, True for bools.
    """
    n = x.shape[0]
    idx = torch.where(idx < 0, idx + n, idx)
    oob = (idx < 0) | (idx >= n)
    out = x[idx.clamp(0, n - 1)]
    if x.dtype == torch.bool:
        fill = True
    elif x.is_floating_point():
        fill = float("nan")
    else:
        fill = torch.iinfo(x.dtype).min
    oob = oob.reshape(oob.shape + (1,) * (out.dim() - 1))
    return torch.where(oob, torch.full((), fill, dtype=x.dtype,
                                       device=x.device), out)


@dataclasses.dataclass(frozen=True)
class Placed:
    """One tensor placed on a mesh under ``spec``.

    ``parts`` maps ``(device, block)`` to the tensor that device holds.
    Row-sharded: block ``s`` is rows ``[s·rps, (s+1)·rps)``, held by every
    device of model shard ``s`` (a view of the source tensor on its own
    device).  Replicated: block 0 is the whole tensor, held once per
    distinct device.  ``shape``/``dtype`` are the whole tensor's.
    """

    spec: P
    shape: Tuple[int, ...]
    dtype: torch.dtype
    parts: Dict[Tuple[torch.device, int], torch.Tensor]

    @property
    def is_sharded(self) -> bool:
        return _is_sharded(self.spec)

    @property
    def nbytes(self) -> int:
        """Bytes of the whole tensor (the reference's ``size ×
        itemsize``)."""
        n = torch.empty((), dtype=self.dtype).element_size()
        for d in self.shape:
            n *= int(d)
        return n

    def local(self, device: torch.device, s: int = 0) -> torch.Tensor:
        """What ``device`` holds for model shard ``s``."""
        return self.parts[device, s if self.is_sharded else 0]

    def blocks(self) -> Tuple[torch.Tensor, ...]:
        """One tensor per block, in shard order (the first holder's)."""
        out = {}
        for (_, s), t in self.parts.items():
            out.setdefault(s, t)
        return tuple(out[s] for s in sorted(out))

    def full(self) -> torch.Tensor:
        """The whole tensor, on the first holder's device (tests and
        inspection; the forwards read ``local``)."""
        blocks = self.blocks()
        if len(blocks) == 1:
            return blocks[0]
        dev = blocks[0].device
        return torch.cat([b.to(dev) for b in blocks])

    def scatter_rows(self, ids: torch.Tensor,
                     rows: torch.Tensor) -> "Placed":
        """This placement with rows ``ids`` set to ``rows``: only the blocks
        that own an id are copied (on each of their devices)."""
        ids = ids.to(torch.int64)
        parts = dict(self.parts)
        rps = self.shape[0] // len(self.blocks()) if self.is_sharded else 0
        for (dev, s), t in self.parts.items():
            if self.is_sharded:
                sel = (ids >= s * rps) & (ids < (s + 1) * rps)
                if not bool(sel.any()):
                    continue
                local, vals = ids[sel] - s * rps, rows[sel]
            else:
                local, vals = ids, rows
            new = t.clone()
            new[local.to(dev)] = vals.to(device=dev, dtype=t.dtype)
            parts[dev, s] = new
        return dataclasses.replace(self, parts=parts)


def _place(x: Optional[torch.Tensor], spec, grid) -> Optional[Placed]:
    """Place ``x`` on the mesh ``grid`` (``launch.mesh.device_grid``) under
    ``spec``; ``.to`` of a tensor on its own device is the tensor itself,
    so nothing is copied on a virtual mesh over ``x``'s device."""
    if x is None:
        return None
    parts: Dict[Tuple[torch.device, int], torch.Tensor] = {}
    if _is_sharded(spec):
        rps = int(x.shape[0]) // len(grid[0])
        for s in range(len(grid[0])):
            blk = x[s * rps:(s + 1) * rps]
            for row in grid:
                if (row[s], s) not in parts:
                    parts[row[s], s] = blk.to(row[s])
    else:
        for row in grid:
            for dev in row:
                if (dev, 0) not in parts:
                    parts[dev, 0] = x.to(dev)
    return Placed(spec=P(*spec), shape=tuple(int(d) for d in x.shape),
                  dtype=x.dtype, parts=parts)


def _replace_blocks(placed: Placed, x: torch.Tensor, shards, grid
                    ) -> Placed:
    """``placed`` with the blocks of ``shards`` taken anew from the whole
    tensor ``x``; every other block is kept as it is."""
    parts = dict(placed.parts)
    rps = placed.shape[0] // len(grid[0])
    for s in shards:
        blk = x[s * rps:(s + 1) * rps]
        for row in grid:
            parts[row[s], s] = blk.to(row[s])
    return dataclasses.replace(placed, parts=parts)


@dataclasses.dataclass(frozen=True)
class ShardedArm:
    """One star arm's quasi-static serving state, placed on the mesh.

    ``table`` is the arm's prefused partial (fused backend) or projected
    feature block (nonfused).  When ``spec`` row-shards it, the probe state
    is sharded to match: ``sorted_pk``/``order`` hold the per-shard
    ``ShardedPKIndex`` slices (shard-local row offsets) and ``dmask`` the
    per-shard dimension-predicate mask, in the same contiguous row blocks.
    The probe state is ``None`` on the global-pointer path
    (``CompiledQuery.predict_rows``), where the FK→row resolution already
    happened offline.
    """

    fk_col: str
    spec: P
    table: Placed                   # (r, w)
    sorted_pk: Optional[Placed]     # (r,) per-shard sorted | None
    order: Optional[Placed]         # (r,) shard-local offsets | None
    dmask: Optional[Placed]         # (r,) bool | None

    @property
    def is_sharded(self) -> bool:
        return _is_sharded(self.spec)


@dataclasses.dataclass(frozen=True)
class ShardedPrefusedPartials:
    """All arms' prefused partials placed across ``mesh``: the sharded
    counterpart of ``PrefusedStar`` plus the per-arm lookup state, built by
    :func:`shard_prefused_partials`."""

    mesh: object                    # launch.mesh.Mesh
    shard_axis: str
    arms: Tuple[ShardedArm, ...]
    h: Optional[Placed]             # tree compare vector, replicated

    @property
    def placement(self) -> Tuple[P, ...]:
        return tuple(a.spec for a in self.arms)

    @property
    def num_sharded(self) -> int:
        return sum(1 for a in self.arms if a.is_sharded)

    @property
    def grid(self) -> Tuple[Tuple[torch.device, ...], ...]:
        """The mesh's devices as (data-parallel rows, model shards)."""
        return device_grid(self.mesh, self.shard_axis)

    @property
    def out_device(self) -> torch.device:
        """Where the forwards' outputs land: shard 0 of the first
        data-parallel row."""
        return self.grid[0][0]

    def nbytes_per_device(self) -> int:
        """Quasi-static bytes resident per mesh position under this
        placement: the partials and the per-arm probe state (PK-index
        slices, predicate masks), a row-sharded arm's divided by the shard
        count — the reference's formula, so both packages report one
        number for one placement."""
        total = 0
        for a in self.arms:
            n = sum(x.nbytes for x in (a.table, a.sorted_pk, a.order,
                                       a.dmask) if x is not None)
            if a.is_sharded:
                n //= int(self.mesh.shape[self.shard_axis])
            total += n
        if self.h is not None:
            total += self.h.nbytes
        return total


def shard_prefused_partials(
        mesh, arms: Sequence[Tuple[str, Optional[torch.Tensor],
                                   Optional[torch.Tensor], torch.Tensor]],
        h: Optional[torch.Tensor], specs: Sequence[P], *,
        shard_axis: str = "model") -> ShardedPrefusedPartials:
    """Place each arm's ``(fk_col, pk, dmask, table)`` per its spec.

    Arms whose spec row-shards get per-shard ``ShardedPKIndex`` slices in
    contiguous-block layouts; replicated arms keep the global ``PKIndex``.
    ``pk``/``dmask`` may be ``None`` for the global-pointer
    (``predict_rows``) path.  The indices are built on the tables' device
    and the blocks then go to their shards' devices.
    """
    grid = device_grid(mesh, shard_axis)
    num_shards = len(grid[0])
    placed = []
    for (fk_col, pk, dmask, table), spec in zip(arms, specs):
        sharded = _is_sharded(spec)
        if pk is None:
            sorted_pk = order = None
        elif sharded:
            sidx = shard_pk_index(pk, num_shards)
            sorted_pk = sidx.sorted_pk.reshape(-1)
            order = sidx.order.reshape(-1)
        else:
            gidx = pk_index(pk)
            sorted_pk, order = gidx.sorted_pk, gidx.order
        vec_spec = P(shard_axis) if sharded else P(None)
        placed.append(ShardedArm(
            fk_col=fk_col, spec=P(*spec),
            table=_place(table, spec, grid),
            sorted_pk=_place(sorted_pk, vec_spec, grid),
            order=_place(order, vec_spec, grid),
            dmask=_place(None if dmask is None else dmask.to(torch.bool),
                         vec_spec, grid)))
    return ShardedPrefusedPartials(mesh=mesh, shard_axis=shard_axis,
                                   arms=tuple(placed),
                                   h=_place(h, P(None), grid))


def _accumulate(parts, valid, h, model, backend: str) -> torch.Tensor:
    """The online tail, in the arm and operation order of the single-device
    runtime (``ServingRuntime._online_fused`` / ``_online_nonfused`` and
    ``_forward``), so float32 results stay bit for bit."""
    if backend == "fused":
        acc = parts[0]
        for part in parts[1:]:
            acc = acc + part
        if h is not None:
            acc = acc * valid[:, None].to(acc.dtype)
            acc = (acc == h[None, :].to(acc.dtype)).to(acc.dtype)
        out = acc
    else:
        t = torch.cat(parts, dim=1) * valid[:, None].to(torch.float32)
        out = model.apply(t)
    return out * valid[:, None].to(out.dtype)


def _model_on(model, backend: str, devices) -> Dict[torch.device, object]:
    """The replicated model tail (nonfused heads), one per merge device."""
    if backend == "fused":
        return {}
    if not isinstance(model, (LinearOperator, DecisionTreeGEMM)):
        raise TypeError(
            f"no sharded lowering for model {type(model).__name__}")
    return {d: model.to(d) for d in dict.fromkeys(devices)}


def serving_arm_state(sp: ShardedPrefusedPartials) -> Tuple:
    """The placed per-arm serving state, ``(table, sorted_pk, order,
    dmask)`` per arm: passed to the forward at call time, so a runtime's
    refresh swaps in extended arms without a new forward."""
    return tuple((a.table, a.sorted_pk, a.order, a.dmask) for a in sp.arms)


def extend_sharded_arm(sp: ShardedPrefusedPartials, j: int,
                       table: Placed, pk: Optional[torch.Tensor],
                       dmask: Optional[torch.Tensor], lo: int, hi: int
                       ) -> ShardedArm:
    """Re-place arm ``j`` after rows ``[lo, hi)`` changed, touching only the
    shard blocks that own them.

    ``table`` is the arm's placed table with the changed rows already
    written (``Placed.scatter_rows``, which copies only the blocks owning
    them); ``pk`` and ``dmask`` are whole tensors.  In the contiguous-block
    layout appended rows land in the tail block(s): only those shards'
    ``ShardedPKIndex`` slices are argsorted again (stably, on the device,
    ``rows_per_shard`` keys each); every other block's index, order and
    mask tensors are kept as they are.  A replicated arm rebuilds its
    (small) index and is placed anew.  Shapes and specs do not change.
    """
    arm = sp.arms[j]
    grid = sp.grid
    if not arm.is_sharded:
        idx = pk_index(pk) if pk is not None else None
        return dataclasses.replace(
            arm, table=table,
            sorted_pk=_place(idx.sorted_pk if idx else None, P(None), grid),
            order=_place(idx.order if idx else None, P(None), grid),
            dmask=_place(None if dmask is None else dmask.to(torch.bool),
                         P(None), grid))
    num_shards = len(grid[0])
    rps = table.shape[0] // num_shards
    owners = range(lo // rps, -(-hi // rps))   # shard blocks owning [lo, hi)
    sorted_pk, order = arm.sorted_pk, arm.order
    if pk is not None:
        blocks = pk.reshape(num_shards, rps)
        sp_parts, od_parts = dict(sorted_pk.parts), dict(order.parts)
        for s in owners:
            o = torch.argsort(blocks[s], stable=True).to(torch.int32)
            keys = blocks[s][o]
            for row in grid:
                sp_parts[row[s], s] = keys.to(row[s])
                od_parts[row[s], s] = o.to(row[s])
        sorted_pk = dataclasses.replace(sorted_pk, parts=sp_parts)
        order = dataclasses.replace(order, parts=od_parts)
    new_dmask = arm.dmask
    if dmask is not None:
        new_dmask = _replace_blocks(arm.dmask, dmask.to(torch.bool), owners,
                                    grid)
    return dataclasses.replace(arm, table=table, sorted_pk=sorted_pk,
                               order=order, dmask=new_dmask)


def make_serving_forward(sp: ShardedPrefusedPartials, model, backend: str):
    """The sharded online phase of ``ServingRuntime``: fks → predictions.

    ``forward(fks, arms)`` takes a padded ``(J, bucket)`` key block (the
    bucket a multiple of the data-parallel size) and
    :func:`serving_arm_state`.  Data-parallel row ``i`` serves rows
    ``[i·b, (i+1)·b)``; for it each row-sharded arm probes every model
    shard's index slice and gathers its partial rows on that shard's
    device, and the ``(part, hit count)`` pairs are summed in shard order
    on the row's merge device, where replicated arms probe and gather and
    the tail runs.  The rows' outputs are joined on ``sp.out_device``.
    """
    grid = sp.grid
    out_dev = sp.out_device
    models = _model_on(model, backend, [row[0] for row in grid])
    sharded = [a.is_sharded for a in sp.arms]
    h = sp.h

    def _arm(j, fk, row, table, sorted_pk, order, dmask):
        m = row[0]
        if not sharded[j]:
            fj = PKIndex(sorted_pk.local(m), order.local(m)).probe(fk.to(m))
            hit = fj.found & dmask.local(m)[fj.ptr]
            tbl = table.local(m)
            return tbl.index_select(0, fj.ptr) * hit[:, None].to(
                tbl.dtype), hit
        part = count = None
        for s, dev in enumerate(row):
            fj = PKIndex(sorted_pk.local(dev, s),
                         order.local(dev, s)).probe(fk.to(dev))
            hit = fj.found & dmask.local(dev, s)[fj.ptr]
            tbl = table.local(dev, s)
            p = (tbl.index_select(0, fj.ptr)
                 * hit[:, None].to(tbl.dtype)).to(m)
            c = hit.to(device=m, dtype=torch.int32)
            part = p if part is None else part + p
            count = c if count is None else count + c
        return part, count > 0

    def forward(fks, arms):
        n = int(fks[0].shape[0])
        if n % len(grid):
            raise ValueError(f"batch of {n} rows does not split over "
                             f"{len(grid)} data-parallel rows")
        b = n // len(grid)
        outs = []
        for i, row in enumerate(grid):
            parts, hits = [], []
            for j, state in enumerate(arms):
                part, hit = _arm(j, fks[j][i * b:(i + 1) * b], row, *state)
                parts.append(part)
                hits.append(hit)
            valid = hits[0]
            for hit in hits[1:]:
                valid = valid & hit
            out = _accumulate(parts, valid,
                              h.local(row[0]) if h is not None else None,
                              models.get(row[0]), backend)
            outs.append(out.to(out_dev))
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    return forward


def predict_rows_state(sp: ShardedPrefusedPartials,
                       tables: Sequence[torch.Tensor],
                       ptrs: Sequence[torch.Tensor],
                       founds: Sequence[torch.Tensor],
                       row_valid: torch.Tensor) -> dict:
    """Placed call-time state for :func:`make_predict_rows_forward`.

    Pointers and validity replicate; each arm table keeps its planned spec.
    Rebuilt whole on refresh (on a virtual mesh over the tables' device
    every entry is the plan's own tensor, or a view of it).
    """
    grid = sp.grid
    rep = P(None)
    return {
        "ptrs": tuple(_place(p, rep, grid) for p in ptrs),
        "founds": tuple(_place(f.to(torch.bool), rep, grid)
                        for f in founds),
        "valid": _place(row_valid.to(torch.bool), rep, grid),
        "tables": tuple(_place(t, a.spec, grid)
                        for t, a in zip(tables, sp.arms)),
    }


def make_predict_rows_forward(sp: ShardedPrefusedPartials, model,
                              backend: str):
    """Sharded ``CompiledQuery.predict_rows``: fact row ids → predictions.

    The FK→row resolution already ran offline, so the per-arm pointers are
    global row numbers; each model shard serves the pointers that land in
    its block, and the contributions are summed in shard order.  Every
    data-parallel row would compute the same whole batch (the reference's
    ids are replicated), so the first row computes it.  Ids outside the
    fact table read the single-device gather's fill: a NaN row per arm,
    then the same tail as the port's single-device ``predict_rows``.
    ``forward(row_ids, state)`` takes :func:`predict_rows_state`.
    """
    row = sp.grid[0]
    m = row[0]
    mdl = _model_on(model, backend, [m]).get(m)
    h = sp.h.local(m) if sp.h is not None else None
    sharded = [a.is_sharded for a in sp.arms]

    def forward(row_ids, state):
        ids = row_ids.to(m)
        valid = state["valid"].local(m)
        n = valid.shape[0]
        wrapped = torch.where(ids < 0, ids + n, ids)
        oob = (wrapped < 0) | (wrapped >= n)
        v = _take(valid, ids)
        parts = []
        for j, tables in enumerate(state["tables"]):
            ptr = _take(state["ptrs"][j].local(m), ids)
            hit = _take(state["founds"][j].local(m), ids)
            if not sharded[j]:
                tbl = tables.local(m)
                parts.append(_take(tbl, ptr) * hit[:, None].to(tbl.dtype))
                continue
            rps = tables.shape[0] // len(row)
            part = None
            for s, dev in enumerate(row):
                lo = s * rps
                g = ptr.to(dev)
                own = (g >= lo) & (g < lo + rps) & hit.to(dev)
                tbl = tables.local(dev, s)
                p = (tbl[(g - lo).clamp(0, rps - 1)]
                     * own[:, None].to(tbl.dtype)).to(m)
                part = p if part is None else part + p
            parts.append(torch.where(oob[:, None], float("nan"), part))
        if backend == "fused":
            acc = parts[0]
            for p in parts[1:]:
                acc = acc + p
            acc = acc * v[:, None].to(acc.dtype)
            if h is None:
                return acc
            eq = (acc == h[None, :].to(acc.dtype))
            return eq.to(acc.dtype) * v[:, None].to(acc.dtype)
        t = torch.cat(parts, dim=1) * v[:, None].to(torch.float32)
        out = mdl.apply(t)
        return out * v[:, None].to(out.dtype)

    return forward

