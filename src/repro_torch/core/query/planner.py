"""Whole-query cost model: fusion × join backend × aggregation backend ×
serving kernel, and the placement of the serving state over a mesh (port
of ``repro.core.query.planner``).

Thresholds are keyed by torch device type.  The ``"default"`` row is
CPU-seeded; the ``"cuda"`` row holds only what was measured on the card, and
every other threshold of a CUDA plan reads the default row.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from ...kernels.fused_star_gather.ops import MAX_ARMS
from ...launch.sharding import P, safe_spec
from ..fusion.operators import DecisionTreeGEMM
from ..fusion.planner import FusionDecision, plan_fusion
from .ir import Model

PLANNER_THRESHOLDS = {
    "default": {
        # Dense one-hot row-matching matrices only when (fact × dim) is
        # small (paper §4.2: MM-Join loses to pointer joins at scale).
        "DENSE_JOIN_ELEMS": 1 << 14,
        # One-hot matmul aggregation is picked while its FLOP overcount
        # (≈2·G) stays under this advantage over a scatter segment-sum.
        "MXU_SEGMENT_ADVANTAGE": 16.0,
        # Largest tree (internal nodes) that "auto" serves on tree_predict.
        "TREE_KERNEL_MAX_NODES": 16384,
        # Snowflake chains: total bytes of cached hop probes (int32 ptr +
        # bool found per parent row) a chain may pin to speed its refresh.
        # Hops are cached parent-first until the budget runs out
        # (materialize-at-hop-k); a zero or overflowing budget prefuses
        # through.
        "CHAIN_CACHE_BYTES": 1 << 22,
        # Below this size a prefused partial (or projected feature table)
        # is replicated over the serving mesh rather than row-sharded: it
        # fits every device and its gather needs no merge.  The reference's
        # CPU-seeded value; not measured on the card.
        "SHARD_PARTIAL_BYTES": 1 << 20,
    },
    "cuda": {
        # tree_predict against the plain torch version on an H100 80GB HBM3
        # at 700 W (scripts/torch_tree_predict_times.py; the tensor-core
        # design), kernel vs plain ms: p=7 1.258 vs 10.90 (60M rows),
        # p=127 2.245 vs 16.00 (4.8M), at 6000 rows p=511 0.102 vs 0.221,
        # p=1023 0.312 vs 0.520, p=2047 0.922 vs 1.490, p=4095 3.33 vs
        # 4.91, p=8191 12.88 vs 16.55, and at 512 rows p=511 0.064 vs
        # 0.117, p=2047 0.143 vs 0.200, p=8191 1.368 vs 1.531.  The kernel
        # won at every width, so the row is SERVE_KERNEL_MAX_NODES.
        "TREE_KERNEL_MAX_NODES": 16384,
    },
}

# The reference's module-level aliases of the default row.  Both read the
# "default" row: the "cuda" row has no entry for either (it is not
# calibrated on the card), so a CUDA plan reads these same values.
DENSE_JOIN_ELEMS = PLANNER_THRESHOLDS["default"]["DENSE_JOIN_ELEMS"]
MXU_SEGMENT_ADVANTAGE = PLANNER_THRESHOLDS["default"]["MXU_SEGMENT_ADVANTAGE"]
SHARD_PARTIAL_BYTES = PLANNER_THRESHOLDS["default"]["SHARD_PARTIAL_BYTES"]

# Kernel bounds.  fused_star_gather takes at most 8 arms (its by-value
# partial table); tree_predict stages a tile of at least 16 rows of x (16·k
# floats) beside 128 nodes' predicates and H fragments in one block's
# shared memory, which k <= 1024 keeps under Hopper's 227 KiB (nodes and
# leaves stream through in chunks).
SERVE_KERNEL_MAX_WIDTH = 8192
SERVE_KERNEL_MAX_NODES = 16384
SERVE_KERNEL_MAX_FEATURES = 1024
SERVE_KERNEL_MAX_ARMS = MAX_ARMS

SERVE_BACKENDS = ("auto", "torch", "kernel")


def planner_threshold(name: str, platform: Optional[str] = None):
    """The calibrated threshold ``name`` for torch device type ``platform``.

    Platforms without a calibration row read the ``"default"`` row.
    """
    defaults = PLANNER_THRESHOLDS["default"]
    if name not in defaults:
        raise KeyError(f"unknown planner threshold {name!r}; expected one "
                       f"of {sorted(defaults)}")
    return PLANNER_THRESHOLDS.get(platform, defaults).get(name, defaults[name])


@dataclasses.dataclass(frozen=True)
class AggDecision:
    backend: str            # "segment" | "matmul"
    matmul_flops: float
    segment_flops: float
    reason: str


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    backend: str            # "fused" | "nonfused"
    join_backend: str       # "gather" | "matmul"
    agg: Optional[AggDecision]
    fusion: Optional[FusionDecision]
    selectivity: float
    reason: str
    serve_backend: str = "torch"   # "torch" | "kernel"
    # Per-arm placement of the quasi-static row tables (prefused partials or
    # projected features) over the serving mesh; None when planned without
    # a mesh.
    partition_specs: Optional[Tuple[P, ...]] = None
    # Out-of-core: rows per fact chunk when the plan streams the fact axis
    # (None = in-core).  Decided by plan_streaming from the fact working-set
    # bytes against the device-memory budget, or pinned by the caller.
    stream_chunk_rows: Optional[int] = None


def _mesh_platform(mesh) -> Optional[str]:
    """The device type of a port ``Mesh`` (None for a mesh stand-in)."""
    devices = getattr(mesh, "devices", None)
    if devices is None or not getattr(devices, "size", 0):
        return None
    return getattr(devices.flat[0], "type", None)


def plan_partition_spec(mesh, shape: Sequence[int], *, itemsize: int = 4,
                        axis: str = "model",
                        threshold: Optional[int] = None) -> Tuple[P, str]:
    """Placement for one quasi-static row table: replicate or row-shard.

    Small tables replicate (the online gather needs no merge); tables of
    ``threshold`` bytes or more (default: ``SHARD_PARTIAL_BYTES`` for the
    mesh's device type) row-shard over the mesh's ``axis`` through
    ``safe_spec``, so a row count that does not divide the axis replicates
    instead of failing.  Returns ``(spec, reason)``; the reasons are the
    reference's, character for character.
    """
    if threshold is None:
        threshold = planner_threshold("SHARD_PARTIAL_BYTES",
                                      _mesh_platform(mesh))
    replicated = P(*([None] * len(shape)))
    if mesh is None:
        return replicated, "no mesh: replicate"
    nbytes = itemsize
    for d in shape:
        nbytes *= int(d)
    if nbytes < threshold:
        return replicated, (f"{nbytes}B < {threshold}B: replicate small "
                            "partial")
    spec = safe_spec(mesh, shape, axis, *([None] * (len(shape) - 1)))
    if spec[0] is None:
        return spec, (f"rows={shape[0]} does not divide mesh[{axis!r}]: "
                      "replicate (safe_spec fallback)")
    return spec, f"row-shard {shape[0]} rows over {axis}={mesh.shape[axis]}"


def plan_placements(mesh, shapes: Sequence[Sequence[int]], *,
                    itemsize: int = 4, axis: str = "model",
                    threshold: Optional[int] = None
                    ) -> Tuple[Tuple[P, ...], str]:
    """Per-arm placement over the arms' row-table shapes: ``(specs,
    reason)``, the reason in the plan's ``place=[...]`` format."""
    specs, whys = [], []
    for shape in shapes:
        spec, why = plan_partition_spec(mesh, shape, itemsize=itemsize,
                                        axis=axis, threshold=threshold)
        specs.append(spec)
        whys.append(why)
    return tuple(specs), "place=[" + "; ".join(whys) + "]"


def place_tables(mesh, tables, plan: "QueryPlan", *, axis: str = "model",
                 threshold_bytes: Optional[int] = None
                 ) -> Tuple[Tuple[P, ...], "QueryPlan"]:
    """Placement of the *actual* arm row tables, recorded on the plan.

    Shared by ``compile_query(mesh=)`` and ``compile_serving(mesh=)``:
    fused partial widths differ from nonfused feature widths, so the
    placement is derived from the real table shapes, and the plan's
    ``partition_specs`` and reason say what runs.
    """
    specs, place = plan_placements(
        mesh, [tuple(t.shape) for t in tables],
        itemsize=tables[0].element_size(), axis=axis,
        threshold=threshold_bytes)
    plan = dataclasses.replace(plan, partition_specs=specs,
                               reason=plan.reason + "; " + place)
    return specs, plan


def resolve_mesh_serve_backend(serve_backend: str, mesh) -> str:
    """The serve backend of mesh serving: plain torch.

    The kernels are not composed with the sharded program (neither are the
    reference's Pallas kernels with its ``shard_map``), so an explicit
    ``"kernel"`` beside a mesh raises rather than silently running plain
    torch; ``"auto"`` and ``"torch"`` resolve to ``"torch"``.
    """
    if mesh is None:
        return serve_backend
    if serve_backend == "kernel":
        raise ValueError(
            "serve_backend='kernel' does not compose with mesh serving: "
            "the sharded program runs the plain gathers; use "
            "serve_backend='torch' or 'auto'")
    return "torch"


def plan_serving_backend(model: Optional[Model], num_arms: int, *,
                         backend: str = "fused",
                         platform: str) -> Tuple[str, str]:
    """Physical backend of the online step: hand-written kernel or torch.

    Returns ``(backend, reason)``.  On ``cuda`` the kernel is the default
    whenever the shapes fit its bounds and, for a nonfused tree, the tree is
    no larger than ``TREE_KERNEL_MAX_NODES``; on ``cpu`` there is no kernel
    to run, so it is ``"torch"``.
    """
    if model is None:
        return "torch", "no model head: nothing to lower onto a kernel"
    if platform != "cuda":
        return "torch", f"device {platform!r}: the CUDA kernels need a card"
    if backend == "fused":
        if not 1 <= num_arms <= SERVE_KERNEL_MAX_ARMS:
            return "torch", (f"J={num_arms} arms outside fused_star_gather's "
                             f"1..{SERVE_KERNEL_MAX_ARMS}")
        if model.l > SERVE_KERNEL_MAX_WIDTH:
            return "torch", (f"l={model.l} exceeds fused_star_gather width "
                             f"bound {SERVE_KERNEL_MAX_WIDTH}")
        return "kernel", (f"cuda: fused_star_gather fits (J={num_arms}, "
                          f"l={model.l})")
    if isinstance(model, DecisionTreeGEMM):
        if not (model.p <= SERVE_KERNEL_MAX_NODES
                and model.l <= SERVE_KERNEL_MAX_WIDTH
                and model.k <= SERVE_KERNEL_MAX_FEATURES):
            return "torch", (f"tree k={model.k}/p={model.p}/l={model.l} "
                             "exceeds tree_predict's bounds")
        max_nodes = planner_threshold("TREE_KERNEL_MAX_NODES", platform)
        if model.p > max_nodes:
            return "torch", (f"cuda: tree p={model.p} above {max_nodes} "
                             "nodes, where tree_predict measured slower "
                             "than torch")
        return "kernel", (f"cuda: tree_predict fits (k={model.k}, "
                          f"p={model.p}, l={model.l})")
    return "torch", "nonfused linear head: no kernel, torch.matmul"


def resolve_serve_backend(serve_backend: str, backend: str, model) -> str:
    """Clamp a requested serve backend to one that has a kernel.

    A non-fused linear head has no kernel (its online step is a plain
    matmul), so a "kernel" request becomes "torch" there.
    """
    if serve_backend != "kernel" or backend == "fused":
        return serve_backend
    return "kernel" if isinstance(model, DecisionTreeGEMM) else "torch"


def effective_serve_backend(plan: QueryPlan, serve_backend: str,
                            backend: str, model, num_arms: int, *,
                            platform: str) -> str:
    """The serve backend that will actually execute.

    "auto" is re-planned against the resolved execution backend; explicit
    choices are clamped only where no kernel exists.
    """
    if serve_backend == "auto":
        if backend == plan.backend:
            return plan.serve_backend
        return plan_serving_backend(model, num_arms, backend=backend,
                                    platform=platform)[0]
    return resolve_serve_backend(serve_backend, backend, model)


def plan_streaming(requested, fact_rows: int, fact_row_bytes: int,
                   memory_budget_bytes: Optional[int]
                   ) -> Tuple[Optional[int], str]:
    """In-core vs out-of-core for the fact axis; returns ``(chunk, reason)``.

    The working set of the online program is ~``fact_rows ×
    fact_row_bytes`` (matrix columns, join pointers, validity, group ids,
    plus the fact-sized intermediates the program makes).  A caller that
    pins ``stream_chunk_rows`` to an int decides; ``"auto"`` streams with
    budget-sized chunks; ``None`` streams only when ``memory_budget_bytes``
    is given and the working set exceeds it.  The reasons are the
    reference's, character for character.
    """
    from .streaming import plan_chunk_rows
    est = int(fact_rows) * max(int(fact_row_bytes), 1)
    chunk = plan_chunk_rows(requested, int(fact_rows), int(fact_row_bytes),
                            memory_budget_bytes)
    if chunk is None:
        if memory_budget_bytes is not None:
            return None, (f"stream=off (working set ~{est / 1e6:.1f}MB fits "
                          f"budget {memory_budget_bytes / 1e6:.1f}MB)")
        return None, ""
    if isinstance(requested, int) and requested > 0:
        why = "caller pinned"
    elif memory_budget_bytes is not None:
        why = (f"working set ~{est / 1e6:.1f}MB vs budget "
               f"{memory_budget_bytes / 1e6:.1f}MB")
    else:
        why = "stream_chunk_rows='auto', no budget: default chunk"
    n_chunks = -(-int(fact_rows) // chunk) if fact_rows else 1
    return chunk, (f"stream={chunk} rows/chunk x {n_chunks} ({why}; fused "
                   "segment fold, dimension-side artifacts shared)")


def plan_chain_materialization(chain_name: str, parent_rows: Sequence[int],
                               *, strategy: str = "auto",
                               platform: Optional[str] = None
                               ) -> Tuple[int, str]:
    """Where along a snowflake chain to materialize: ``(k, reason)``.

    Collapsing a chain probes each hop at its parent's granularity.  The
    first ``k`` probes can be cached on the collapsed chain, so a refresh
    re-probes only hops whose tables changed, at ``parent_rows[i] × 5``
    resident bytes per cached hop (int32 ptr + bool found).  Hops are
    admitted parent-first while the total fits ``CHAIN_CACHE_BYTES``;
    ``strategy`` overrides: ``"through"`` caches nothing, ``"materialize"``
    caches every hop.
    """
    n = len(parent_rows)
    costs = [int(r) * 5 for r in parent_rows]
    if strategy == "through":
        return 0, f"chain[{chain_name}]: prefuse-through (caller pinned)"
    if strategy == "materialize":
        return n, (f"chain[{chain_name}]: materialize@{n}/{n} "
                   f"(caller pinned; hop cache {sum(costs)}B)")
    if strategy != "auto":
        raise ValueError(f"chain_strategy {strategy!r} not one of "
                         "('auto', 'through', 'materialize')")
    budget = planner_threshold("CHAIN_CACHE_BYTES", platform)
    k, spent = 0, 0
    for c in costs:
        if spent + c > budget:
            break
        spent += c
        k += 1
    if k == 0:
        return 0, (f"chain[{chain_name}]: prefuse-through (hop cache "
                   f"{costs[0] if costs else 0}B exceeds budget {budget}B)")
    return k, (f"chain[{chain_name}]: materialize@{k}/{n} (hop cache "
               f"{spent}B fits budget {budget}B; refresh reuses unchanged "
               "hops)")


def plan_aggregation(online_rows: float, num_groups: int, out_width: int,
                     ops: Sequence[str] = ("sum",),
                     platform: Optional[str] = None) -> AggDecision:
    """Fig. 4 matmul vs segment-sum, costed over the whole aggregate set."""
    i = max(online_rows, 1.0)
    g = max(num_groups, 1)
    l = max(out_width, 1)
    ops = tuple(ops) or ("sum",)
    n_sums = sum(1 for op in ops if op in ("sum", "mean"))
    needs_count = any(op in ("count", "mean") for op in ops)
    n_minmax = sum(1 for op in ops if op in ("min", "max"))
    matmul = 2.0 * i * g * l * n_sums + (2.0 * i * g if needs_count else 0.0)
    segment = (i * l + i) * n_sums + (2.0 * i if needs_count else 0.0)
    shared = (i * l + i) * n_minmax
    advantage = planner_threshold("MXU_SEGMENT_ADVANTAGE", platform)
    if matmul > 0 and matmul <= segment * advantage:
        return AggDecision("matmul", matmul + shared, segment + shared,
                           f"G={g} small: one-hot matmul beats scatter")
    return AggDecision("segment", matmul + shared, segment + shared,
                       f"G={g}: segment ops ({segment + shared:.0f} flops) "
                       f"beat one-hot matmul ({matmul + shared:.0f} flops)")


def estimate_query_cost(model: Optional[Model], fact_rows: int,
                        dim_rows: Sequence[int], *, num_groups: int = 0,
                        out_width: int = 1, agg_ops: Sequence[str] = ("sum",),
                        batches_per_update: float = 1000.0,
                        platform: Optional[str] = None) -> float:
    """Scalar per-batch work estimate (online phase + amortized prefuse)."""
    n = float(max(fact_rows, 1))
    j = max(len(dim_rows), 1)
    r = float(sum(dim_rows)) if dim_rows else 0.0
    cost = 2.0 * n * j
    if model is not None:
        l = max(model.l, 1)
        cost += n * (j + 1) * l
        offline = 2.0 * r * max(model.k, 1) * l
        if isinstance(model, DecisionTreeGEMM):
            offline += r * model.p * (l + 2.0)
            cost += n * l
        cost += offline / max(batches_per_update, 1.0)
    if num_groups > 0:
        agg = plan_aggregation(n, num_groups, out_width, ops=agg_ops,
                               platform=platform)
        cost += min(agg.matmul_flops, agg.segment_flops)
    return cost


def plan_query(model: Optional[Model], fact_rows: int,
               dim_rows: Sequence[int], *, platform: str,
               selectivity: float = 1.0, num_groups: int = 0,
               out_width: int = 1, agg_ops: Sequence[str] = ("sum",),
               batches_per_update: float = 1000.0,
               memory_budget_bytes: Optional[int] = None,
               sharing: float = 1.0, mesh=None, shard_axis: str = "model",
               shard_threshold_bytes: Optional[int] = None) -> QueryPlan:
    """Pick fused/nonfused + join/agg/serving backends for one query on
    torch device type ``platform``.

    With a ``mesh`` the plan also places each arm's quasi-static row table
    (``partition_specs``): each prefused partial is sized as (dimension
    rows × out_width) float32 and replicated or row-sharded over
    ``shard_axis`` (:func:`plan_partition_spec`).

    ``memory_budget_bytes`` bounds the resident prefused partials: past it
    the fusion decision falls back to nonfused (``plan_fusion``).

    ``sharing`` (≥ 1) is the artifact pool's hint: how many plans share
    this query's join artifacts.  A partial referenced by N plans amortizes
    its one-time prefuse over N × the batches, which the fusion decision
    models by scaling ``batches_per_update``.
    """
    sel = min(max(float(selectivity), 0.0), 1.0)
    online_rows = float(fact_rows) * sel
    sharing = max(float(sharing), 1.0)

    fusion = None
    backend = "fused"
    if model is not None:
        fusion = plan_fusion(model, fact_rows, dim_rows,
                             batches_per_update=batches_per_update * sharing,
                             memory_budget_bytes=memory_budget_bytes,
                             selectivity=sel)
        backend = "fused" if fusion.fuse else "nonfused"

    dense_elems = float(fact_rows) * float(max(dim_rows, default=1))
    join_backend = ("matmul" if dense_elems <= planner_threshold(
        "DENSE_JOIN_ELEMS", platform) else "gather")

    agg = None
    if num_groups > 0:
        agg = plan_aggregation(online_rows, num_groups, out_width,
                               ops=agg_ops, platform=platform)

    serve_backend, serve_reason = plan_serving_backend(
        model, len(dim_rows), backend=backend, platform=platform)

    partition_specs = place_reason = None
    if mesh is not None:
        partition_specs, place_reason = plan_placements(
            mesh, [(int(r), out_width) for r in dim_rows], axis=shard_axis,
            threshold=shard_threshold_bytes)

    parts = [f"sel={sel:.3f}", f"join={join_backend}"]
    if sharing > 1.0:
        parts.append(f"sharing={sharing:g}x")
    if fusion is not None:
        parts.append(f"{backend} ({fusion.reason})")
    if agg is not None:
        parts.append(f"agg={agg.backend}")
    parts.append(f"serve={serve_backend} ({serve_reason})")
    if place_reason is not None:
        parts.append(place_reason)
    return QueryPlan(backend=backend, join_backend=join_backend, agg=agg,
                     fusion=fusion, selectivity=sel,
                     reason="; ".join(parts), serve_backend=serve_backend,
                     partition_specs=partition_specs)
