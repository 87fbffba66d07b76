"""Quickstart of the PyTorch/CUDA port: the Session query-builder API, end
to end (the counterpart of ``examples/quickstart.py``, section by
section, through ``repro_torch``).

Builds a small star schema, then drives the paper's whole thesis — the
predictive pipeline σ ⋈ model γ as ONE linear-algebra program — through the
single fluent entry point, ``repro_torch.core.query.Session``:

  1. declare the pipeline once (joins, predicates, model head, group-by,
     *several named aggregates*),
  2. ``.run()`` the whole-query aggregate program (sum/mean/count fused
     over shared join+model work, ``num_groups="auto"``),
  3. ``.rows()`` row predictions, fused == non-fused (paper Eq. 1),
  4. ``.serve()`` the bucketed dynamic-batch runtime — including sharded
     across a mesh, bit-identical to one device (a *virtual* (2, 4) mesh:
     all eight positions on the run's device, the shards run one after
     another there),
  5. append dimension rows through the versioned ``Catalog`` — every cached
     plan and serving runtime refreshes *in place* (delta prefuse, zero
     recompiles), bit-identical to a cold rebuild,
  6. the admission scheduler, then *workloads* with ``Session.run_all`` —
     shared artifacts through the session's ``ArtifactPool``, compatible
     plans stacked into one class,
  7. go out-of-core: stream the fact axis chunk-at-a-time (bit-identical
     to in-core), tombstone-*delete* fact rows, ``compact()``,
  8. chain joins into *snowflake* dimensions and let the rewrite engine
     drop a model a leaf filter makes redundant.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core.fusion import LinearOperator
from repro_torch.core.laq import Table
from repro_torch.core.query import PREDICTION, Catalog, Session
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_serving_mesh

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the card)")
dev = resolve_device(ap.parse_args().device)


def arr(x):
    """A result as a numpy array (results are tensors on ``dev``)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_aggregate(got, want):
    """Two ``run()`` aggregates: bit for bit on the CPU.  On the card a
    group's float sum adds with atomics, in no fixed order, so float
    aggregates agree to float32 summation order there (rtol 1e-5); counts,
    min/max and integer-valued sums stay exact."""
    if dev.type == "cuda":
        np.testing.assert_allclose(arr(got), arr(want), rtol=1e-5, atol=0)
    else:
        np.testing.assert_array_equal(arr(got), arr(want))


rng = np.random.default_rng(0)

# -- 1. Relations (a fact table + two dimension tables) ---------------------
# A Catalog is the mutable, *versioned* data surface: appends/updates bump
# per-table version counters and every cached plan refreshes incrementally.
# (A plain {name: Table} dict also works — it wraps read-only.)  The
# ``capacity=64`` over-allocation on products leaves padded rows for the
# appends in steps 6–8 to land in without changing any array shape.
catalog = Catalog({
    "customers": Table.from_columns("customers", {
        "custkey": np.arange(100),
        "age": rng.integers(18, 80, 100).astype(np.float32),
        "spend": rng.gamma(2.0, 50.0, 100).astype(np.float32),
    }, key_cols=("custkey",), device=dev),
    "products": Table.from_columns("products", {
        "prodkey": np.arange(40),
        "price": rng.gamma(2.0, 20.0, 40).astype(np.float32),
        "rating": rng.uniform(1, 5, 40).astype(np.float32),
        "category": rng.integers(0, 4, 40),
    }, key_cols=("prodkey", "category"), capacity=64, device=dev),
    "orders": Table.from_columns("orders", {
        "o_custkey": rng.integers(0, 100, 500),
        "o_prodkey": rng.integers(0, 40, 500),
        "quantity": rng.integers(1, 9, 500).astype(np.float32),
    }, key_cols=("o_custkey", "o_prodkey"), device=dev),
})

# -- 2. One fluent pipeline: σ ⋈ model γ -------------------------------------
model = LinearOperator(torch.as_tensor(rng.normal(size=(4, 1)),
                                       dtype=torch.float32, device=dev))
sess = Session(catalog)
pipeline = (sess.query("orders")
            .join("customers", on=("o_custkey", "custkey"),
                  features=["age", "spend"])
            .join("products", on=("o_prodkey", "prodkey"),
                  features=["price", "rating"],
                  where=[("rating", ">", 1.5)])
            .where(("quantity", ">", 2.0))
            .predict(model)
            .group_by(("products", "category", 4), num_groups="auto")
            .agg(qty="sum(quantity)",          # several named aggregates,
                 score=("mean", PREDICTION),   # one compiled program
                 n="count",
                 q_max="max(quantity)"))
print("plan:", pipeline.explain())

# -- 3. .run(): the whole-query aggregate program ----------------------------
res = pipeline.run()
print(f"groups={arr(res['groups'])} n={arr(res['n'])}")
print(f"mean prediction per category: {arr(res['score']).ravel()}")
# The Fig. 4 paper-faithful one-hot matmul backend computes the same thing.
ref = pipeline.run(agg_backend="matmul")
np.testing.assert_allclose(arr(res["qty"]), arr(ref["qty"]),
                           rtol=1e-6)
assert sess.num_plans == 2, "one plan per backend, cached by structure"
print("segment == matmul aggregation ✓")

# -- 4. .rows(): row predictions, fused == non-fused (paper Eq. 1) -----------
ids = np.array([0, 3, 17, 42], np.int32)
fused = pipeline.rows(ids)                       # prefused partials: gathers
nonfused = pipeline.rows(ids, backend="nonfused")  # materialize T, then L
np.testing.assert_allclose(arr(fused), arr(nonfused),
                           rtol=1e-5, atol=1e-5)
print("fused == non-fused row predictions ✓", arr(fused).ravel())

# -- 5. .serve(): dynamic batches, sharded across a mesh ---------------------
# Requests are per-arm foreign keys (not fact rows).  A mesh-bound Session
# row-shards each prefused partial over the "model" axis (per-shard PK-index
# slices → device-local probes + gathers, one psum) and shards the request
# batch over "data"; the threshold is forced to 0 so the toy tables shard.
# The mesh is virtual: its eight positions are all the run's device.
mesh_sess = Session(catalog, mesh=make_serving_mesh((2, 4), device=dev),
                    shard_threshold_bytes=0)
serving = mesh_sess.bind(pipeline.build()).serve(buckets=(8, 64))
reference = pipeline.serve(buckets=(8, 64))
requests = {"o_custkey": np.array([3, 7, 999, 42], np.int32),   # 999: miss
            "o_prodkey": np.array([0, 11, 5, 39], np.int32)}
np.testing.assert_array_equal(arr(serving.serve(requests)),
                              arr(reference.serve(requests)))
print(f"sharded == single-device ✓ on mesh {dict(serving.mesh.shape)}; "
      f"placement={[str(s) for s in serving.plan.partition_specs]}; "
      f"{serving.sharded.nbytes_per_device()}B of partials per device")

# -- 6. Appending dimension rows: incremental prefuse maintenance ------------
# New products arrive.  ``catalog.append`` is transactional: it bumps the
# table's version and logs the delta.  The appended rows fit products'
# padded capacity (64), so every derived artifact refreshes *in place* —
# PK index sorted-merge extend, Eq. 1 partials prefused for ONLY the 6 new
# rows, predicate masks scattered — and the already-compiled programs keep
# executing as compiled: zero recompiles, never a stale partial.
catalog.append("products", {
    "prodkey": np.arange(40, 46),
    "price": rng.gamma(2.0, 20.0, 6).astype(np.float32),
    "rating": rng.uniform(1, 5, 6).astype(np.float32),
    "category": rng.integers(0, 4, 6),
})
compiles_before = reference.num_compiles
print("refresh:", reference.refresh())           # explicit, on a runtime
requests = {"o_custkey": np.array([3, 7], np.int32),
            "o_prodkey": np.array([41, 45], np.int32)}   # the NEW keys
assert reference.num_compiles == compiles_before, "delta refresh recompiled!"
assert np.any(arr(reference.serve(requests)) != 0), "new keys live"

# Session caches are *version-keyed*: the next lookup of any cached plan or
# runtime sees the version bump and refreshes it before returning — a
# Session can never serve pre-append state.  Bit-exact vs a cold rebuild:
res2 = pipeline.run()                            # same plan object, refreshed
cold = Session(catalog).bind(pipeline.build()).run()
for key in ("qty", "score", "n", "q_max"):
    assert_same_aggregate(res2[key], cold[key])
sharded2 = mesh_sess.bind(pipeline.build()).serve(buckets=(8, 64))
np.testing.assert_array_equal(arr(sharded2.serve(requests)),
                              arr(reference.serve(requests)))
print(f"append → refresh ≡ cold rebuild ✓ "
      f"(products now v{catalog.version('products')}, "
      f"{int(catalog['products'].nvalid)} rows; plans cached: "
      f"{sess.num_plans})")

# -- 7. serve(async_=True): the admission scheduler --------------------------
# Synchronous .serve() is a closed loop — right for batch scoring, wrong for
# many concurrent callers.  async_=True registers the same cached runtime on
# the session's AdmissionScheduler: submissions queue per plan, coalesce
# into bucket-shaped batches under a latency SLO, and one drain thread
# serves every registered plan.  Oversized analytical batches are admitted
# in top-bucket chunks on the "batch" lane, so interactive point lookups
# ride along in the same steps instead of queueing behind the scan — and
# everything stays bit-exact vs the synchronous path.
plan = sess.bind(pipeline.build()).serve(buckets=(8, 64), async_=True)
scan = {"o_custkey": rng.integers(0, 20, 200).astype(np.int32),   # 4 chunks
        "o_prodkey": rng.integers(0, 46, 200).astype(np.int32)}
lookup = {"o_custkey": np.array([3], np.int32),
          "o_prodkey": np.array([41], np.int32)}
f_scan = plan.submit(scan, lane="batch")         # Future, chunked admission
f_point = plan.submit(lookup)                    # interleaves with the scan
np.testing.assert_array_equal(arr(f_point.result(30)),
                              arr(reference.serve(lookup)))
np.testing.assert_array_equal(arr(f_scan.result(30)),
                              arr(reference.serve(scan)))
# Data refreshes fence first (drain-then-swap): in-flight requests finish on
# their generation before the swap — never a request spanning two versions.
catalog.append("products", {
    "prodkey": np.arange(46, 48), "price": np.float32([8.0, 9.0]),
    "rating": np.float32([4.5, 3.0]), "category": np.int64([1, 2])})
print("fenced refresh:", sess.scheduler().refresh())
st = plan.stats()
print(f"scheduled serving ✓ steps={st['steps']} "
      f"admitted={st['admitted_rows']} rows "
      f"(backpressure bound rejects with SchedulerBackpressureError; "
      f"tune via sess.scheduler(slo_ms=..., max_queued_rows=...))")
sess.scheduler().close()

# -- 8. Multi-query: shared artifacts + batched execution --------------------
# A Session is a *multi-query* optimizer.  Every plan it compiles acquires
# its physical artifacts — PK indices, factored join pointers, predicate
# masks, Eq. 1 prefused partials — from one reference-counted pool keyed by
# arm content, so a workload of N queries over the same star holds ONE copy
# of each distinct artifact, and a dimension append refreshes it ONCE, not
# once per plan.
variants = [pipeline] + [
    (sess.query("orders")
     .join("customers", on=("o_custkey", "custkey"),
           features=["age", "spend"])
     .join("products", on=("o_prodkey", "prodkey"),
           features=["price", "rating"],
           where=[("rating", ">", 1.5)])
     .where(("quantity", ">", float(thr)))       # only the predicate varies:
     .predict(model)                             # joins/partials are shared
     .group_by(("products", "category", 4), num_groups="auto")
     .agg(qty="sum(quantity)", score=("mean", PREDICTION), n="count",
          q_max="max(quantity)"))
    for thr in (1.0, 4.0, 6.0)]
results = sess.run_all(variants)                 # ONE stacked program: the
for r, b in zip(results, variants):              # four plans share a stacked
    np.testing.assert_array_equal(               # dispatch, bit-exact vs the
        arr(r["qty"]), arr(b.run()["qty"]))  # per-plan path
stats = sess.pool.stats()
print(f"run_all over {len(variants)} variants ✓ pool: "
      f"{stats['entries']} shared artifacts "
      f"({stats['hits']} hits / {stats['misses']} misses, "
      f"{stats['bytes']}B resident, by kind {stats['by_kind']})")
# Structured explains, unified across the surface: str() is the legacy
# one-liner, .as_dict() the machine-readable form, and shared_artifacts
# names the pool keys this plan holds references to.
report = pipeline.explain()
print(f"explain: kind={report.kind} shares {len(report.shared_artifacts)} "
      f"pooled artifacts; trail={list(report.trail)[-1:]}")
# One more append: every plan above is stale, but the pool refreshes each
# distinct artifact exactly once — O(artifacts), not O(plans).
catalog.append("products", {
    "prodkey": np.arange(48, 50),
    "price": np.float32([5.0, 6.0]), "rating": np.float32([2.5, 4.0]),
    "category": np.int64([0, 3])})
updates_before = sess.pool.stats()["updates"]
sess.refresh()
print(f"append → {sess.pool.stats()['updates'] - updates_before} pooled "
      f"artifact updates for {sess.num_plans} cached plans ✓")
sess.evict()                                     # release pool references
assert sess.pool.stats()["entries"] == 0
print("evict → pool drained ✓")

# -- 9. Out-of-core: stream the fact axis, delete rows, compact --------------
# When facts outgrow device memory, a streaming Session folds the SAME
# fused program chunk-at-a-time through a carried segment accumulator —
# bit-identical to in-core, because the chunked fold replays exactly the
# same adds in the same order.  ``memory_budget_bytes`` sizes chunks
# automatically (and auto-streams any plan whose working set exceeds it);
# ``stream_chunk_rows`` pins the chunk size explicitly.
stream_sess = Session(catalog, stream_chunk_rows=128)
q9 = (stream_sess.query("orders")
      .join("customers", on=("o_custkey", "custkey"),
            features=["age", "spend"])
      .join("products", on=("o_prodkey", "prodkey"),
            features=["price", "rating"], where=[("rating", ">", 1.5)])
      .where(("quantity", ">", 2.0))
      .predict(model)
      .group_by(("products", "category", 4), num_groups="auto")
      .agg(qty="sum(quantity)", score=("mean", PREDICTION), n="count"))
plan9 = q9.compile()
# ``stream_chunk_rows=0`` turns streaming OFF for one compile (overrides
# win), pinned to the exact lowering the chunked fold replays:
incore9 = q9.compile(stream_chunk_rows=0, backend="fused",
                     join_backend="gather", agg_backend="segment")
for k, v in incore9.run().items():
    assert_same_aggregate(plan9.run()[k], v)
print("streamed == in-core bitwise ✓ |",
      plan9.explain().as_dict()["extras"]["stream"])

# Deleting fact rows is a tombstone fold: shapes, keys and row placement
# all survive, so every chunk revalidates through the SAME compiled plan —
# a delta refresh with zero rebuilds, exactly like the appends above
# (``traces`` keeps the reference's counter; the port runs eagerly).
traces0 = plan9._stream.traces
catalog.delete_rows("orders", np.arange(0, 500, 5))      # every 5th order
note9 = plan9.refresh()
assert plan9._stream.traces == traces0, "delete refresh rebuilt!"
cold9 = Session(catalog, stream_chunk_rows=128).compile(q9.build())
for k, v in cold9.run().items():
    assert_same_aggregate(plan9.run()[k], v)
print(f"delete → {note9} — 0 retraces, ≡ cold rebuild ✓")

# ``compact()`` garbage-collects tombstones once the dead fraction passes a
# threshold.  Row ids are rewritten, so this is the one lifecycle step that
# must recompile — and the refresh note names the reason.
catalog.delete_rows("orders", np.arange(250, 500))       # bulk churn
assert catalog.compact("orders")
note9 = plan9.refresh()
assert "compaction" in note9
print(f"compact → {note9}; "
      f"{int(arr(catalog['orders'].valid_mask()).sum())} live rows ✓")

# -- 10. Snowflake chains: multi-hop dimensions ------------------------------
# Dimensions can have dimensions.  A chained ``.join`` whose FK lives on an
# already-joined table (or an explicit ``via=[...]``) hangs sub-dimensions
# off an arm, TPC-DS-style; the compiler collapses the chain offline into
# one head-granularity virtual dimension (factored joins compose
# associatively), prefuses it like any flat arm, and the planner explains
# its prefuse-through vs materialize-at-hop choice per chain.
snow = Catalog({
    "countries": Table.from_columns("countries", {
        "co_key": np.arange(4), "tax": np.float32([0., 1., 2., 1.]),
        "co_zone": np.int64([0, 1, 1, 2])},
        key_cols=("co_key", "co_zone"), capacity=8, device=dev),
    "cities": Table.from_columns("cities", {
        "ci_key": np.arange(12), "ci_country": rng.integers(0, 4, 12),
        "density": rng.integers(1, 5, 12).astype(np.float32)},
        key_cols=("ci_key", "ci_country"), capacity=16, device=dev),
    "stores": Table.from_columns("stores", {
        "st_key": np.arange(30), "st_city": rng.integers(0, 14, 30),
        "sqm": rng.integers(1, 9, 30).astype(np.float32)},
        key_cols=("st_key", "st_city"), capacity=40, device=dev),
    "visits": Table.from_columns("visits", {
        "v_store": rng.integers(0, 32, 400),
        "basket": rng.integers(1, 20, 400).astype(np.float32)},
        key_cols=("v_store",), device=dev),
})
snow_sess = Session(snow)
chain_model = LinearOperator(torch.as_tensor(rng.normal(size=(3, 1)),
                                            dtype=torch.float32, device=dev))
q10 = (snow_sess.query("visits")
       .join("stores", on=("v_store", "st_key"), features=["sqm"])
       .join("cities", on=("st_city", "ci_key"),       # FK is on stores →
             features=["density"])                     # chains, not a star
       .join("countries", on=("ci_country", "co_key"), # chains off cities
             features=["tax"], where=[("tax", "<=", 1.5)])
       .predict(chain_model)
       .group_by(("countries", "co_zone", 3), num_groups=3)  # 2 hops deep
       .agg(basket="sum(basket)", score=("mean", PREDICTION), n="count"))
assert len(q10.build().arms) == 1                      # one arm, two links
plan10 = q10.compile()
chain_note = [r for r in plan10.plan.reason.split("; ")
              if r.startswith("chain[")][0]
res10 = q10.run()
print(f"snowflake ✓ {chain_note}")
print(f"  per-zone baskets={arr(res10['basket']).ravel()}")

# Sub-dimension appends refresh the collapsed chain in place — cached plans
# stay bit-identical to a cold rebuild, exactly like flat-arm appends.
snow.append("cities", {"ci_key": np.arange(12, 14),
                       "ci_country": np.int64([3, 0]),
                       "density": np.float32([2.0, 4.0])})
res10b = q10.run()                                     # refreshed in place
for k, v in Session(snow).compile(q10.build()).run().items():
    assert_same_aggregate(res10b[k], v)
print("sub-dimension append → chain refresh ≡ cold rebuild ✓")
# The whole subsystem is fuzzed against a float64 numpy oracle: replay a
# case with ``repro_torch.core.query.workload.check_case(seed)``.

# -- 11. Query/model co-optimization: the IR rewrite engine ------------------
# Because query and model are one algebraic program, optimization crosses
# the boundary between them.  Filter on a tree model's prediction with
# ``.predict(tree, where=[(leaf, "==", 1.0)])``: when the filter selects
# exactly one leaf, the rewrite engine distills that leaf's root-to-leaf
# path into ordinary dimension predicates and DROPS the model — the
# predict-then-filter query runs as a pure relational aggregate, and every
# data refresh skips the fact-sized tree GEMM.  All rewrites are exact:
# ``rewrite="off"`` (the escape hatch) must reproduce results bit-for-bit.
from repro_torch.core.fusion.operators import tree_from_arrays

# Depth-2 stump over [sqm, density, tax]: leaf 3 ⟺ sqm > 4 ∧ sqm > 2.
big_tree = tree_from_arrays(np.array([0, 1, 0]),
                            np.array([4., 2., 2.], np.float32), 3).to(dev)
q11 = (snow_sess.query("visits")
       .join("stores", on=("v_store", "st_key"), features=["sqm"])
       .join("cities", on=("st_city", "ci_key"), features=["density"])
       .join("countries", on=("ci_country", "co_key"), features=["tax"])
       .predict(big_tree, where=[(3, "==", 1.0)])   # big-store visits only
       .agg(basket="sum(basket)", n="count"))
plan11 = q11.compile()
trail = dict(plan11.explain().extras)["rewrites"]
assert any("distill" in t for t in trail)           # also in plan.reason
res11 = q11.run()
off11 = snow_sess.compile(q11.build(), rewrite="off")
np.testing.assert_array_equal(arr(res11["basket"]),
                              arr(off11.run()["basket"]))
print(f"rewrite ✓ {trail[0]}")
print(f"  big-store baskets={arr(res11['basket']).ravel()} "
      f"over n={int(arr(res11['n']).ravel()[0])} visits — no model "
      "online, bit-equal to rewrite='off'")
