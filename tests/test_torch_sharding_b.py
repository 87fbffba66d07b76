"""Port parity, sharding part b: the mesh, the placement planner, the
per-shard indices, the sharded refresh, the scheduler and the session on a
mesh, and a run of the reference's own sharded program.

* ``launch.mesh``: virtual meshes (every position one named device), the
  one-card-per-position rule (no card is used twice, the CPU never stands
  in), ``dp_axes``/``dp_size`` and the (data rows × model shards) device
  grid.
* ``safe_spec``, ``plan_partition_spec``, ``plan_placements`` and
  ``plan_query(mesh=)`` against the reference's, specs and ``place=[...]``
  reasons equal character for character (the reference's planner reads
  only a mesh's ``axis_names`` and ``shape``, so both take one stand-in).
  ``param_pspec`` is the LM scaffold's and is not ported.
* ``ShardedPKIndex``/``shard_rows`` array for array against the
  reference's.
* The sharded delta refresh (``tests/test_incremental.py``'s
  ``test_refresh_sharded_serving_bit_exact``): refreshed ≡ a cold sharded
  compile ≡ a cold single-device one, bit for bit, and only the shard
  blocks owning changed rows are indexed again.
* The scheduler's sharded case (``tests/test_scheduler.py``), the
  session's mesh cache case (``tests/test_session.py``) and ``run_all``
  over a session holding a sharded plan.
* A mesh of distinct device objects (``cpu:0`` … ``cpu:7``), so every
  placement and merge copies: the code path of a mesh over several cards,
  equal to the single-device path.
* One subprocess runs the reference's sharded P1 and P3 (mesh (2, 4), 8
  forced host devices): its specs, reasons, ``nbytes_per_device()`` and
  outputs equal the port's, save P3's out-of-range ``predict_rows`` rows
  (ROADMAP C3).
"""
import os
import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.query as RQ
from repro.core.fusion import LinearOperator as RefLinear
from repro.core.laq import shard_pk_index as ref_shard_pk_index
from repro.core.laq import shard_rows as ref_shard_rows
from repro.launch.sharding import safe_spec as ref_safe_spec
from repro_torch.core.fusion import LinearOperator
from repro_torch.core.laq import PAD_KEY, shard_pk_index, shard_rows
from repro_torch.core.query import (AdmissionScheduler, Session,
                                    compile_query, compile_serving,
                                    plan_partition_spec, plan_placements,
                                    plan_query, stack_key)
from repro_torch.data import QUERY_IR
from repro_torch.launch.mesh import (Mesh, device_grid, dp_axes, dp_size,
                                     make_host_mesh, make_production_mesh,
                                     make_serving_mesh)
from repro_torch.launch.sharding import P, safe_spec
from test_torch_scheduler import _ref_query as sched_query
from test_torch_scheduler import _requests as sched_requests
from test_torch_scheduler import star_catalog as sched_star
from torch_parity import (Both, assert_preds_equal, d1_rows, d2_rows,
                          port_catalog, port_query, ref_models,
                          ref_query, ref_ssb_catalog, ref_star, to_np)

ROOT = Path(__file__).resolve().parents[1]


def _stub_mesh(**axes):
    """A mesh stand-in for the divisibility logic (no devices)."""
    return types.SimpleNamespace(axis_names=tuple(axes), shape=dict(axes))


def _mesh(shape):
    return make_serving_mesh(shape, device="cpu")


# ------------------------------------------------------------------- mesh
def test_virtual_mesh_and_dp_axes():
    mesh = make_serving_mesh((2, 4), device="cpu")
    assert mesh.axis_names == ("data", "model")
    assert dict(mesh.shape) == {"data": 2, "model": 4}
    assert list(mesh.shape) == ["data", "model"]
    assert mesh.size == 8 and mesh.devices.shape == (2, 4)
    assert mesh.distinct_devices() == (torch.device("cpu"),)
    assert dp_axes(mesh) == ("data",) and dp_size(mesh) == 2
    pod = make_serving_mesh((2, 2, 2), ("pod", "data", "model"),
                            device="cpu")
    assert dp_axes(pod) == ("pod", "data") and dp_size(pod) == 4
    assert make_host_mesh(4, device="cpu").devices.shape == (1, 4)
    no_dp = make_serving_mesh((4,), ("model",), device="cpu")
    assert dp_axes(no_dp) == () and dp_size(no_dp) == 1


def test_mesh_takes_one_card_per_position(monkeypatch):
    """Without ``device`` a mesh needs a card per position: it never uses
    a card twice and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="needs 8 CUDA devices, have 2"):
        make_serving_mesh((2, 4))
    with pytest.raises(ValueError, match="needs 256 CUDA devices"):
        make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 CUDA devices"):
        make_production_mesh(multi_pod=True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="no CUDA device"):
        make_host_mesh()
    with pytest.raises(ValueError, match="axes"):
        make_serving_mesh((2, 4), ("data",), device="cpu")


def test_device_grid_orders_rows_and_shards():
    """The grid is (flattened data-parallel axes) × (model axis), in mesh
    order, whatever order the axes are named in."""
    devs = np.empty(8, dtype=object)
    devs[:] = [torch.device("cpu", i) for i in range(8)]
    mesh = Mesh(devs.reshape(2, 4), ("data", "model"))
    grid = device_grid(mesh, "model")
    assert [[d.index for d in row] for row in grid] == [[0, 1, 2, 3],
                                                        [4, 5, 6, 7]]
    swapped = Mesh(devs.reshape(4, 2), ("model", "data"))
    grid = device_grid(swapped, "model")
    assert [[d.index for d in row] for row in grid] == [[0, 2, 4, 6],
                                                        [1, 3, 5, 7]]
    assert [[d.index for d in row] for row in device_grid(mesh, "x")] == [
        [0], [4]]


# ------------------------------------------ safe_spec / placement planner
def test_safe_spec_divisibility_fallback():
    mesh = _stub_mesh(data=1, model=16)
    for shape, axes in (((15, 64), ("model", None)),
                        ((32, 64), ("model", None)),
                        ((16, 4), (("data", "model"), None)),
                        ((8, 4), (("pod", "data"), None))):
        got = safe_spec(mesh, shape, *axes)
        assert got == ref_safe_spec(mesh, shape, *axes), (shape, axes)
        assert isinstance(got, P) and isinstance(got, tuple)
    assert safe_spec(mesh, (15, 64), "model", None) == P(None, None)
    assert safe_spec(mesh, (32, 64), "model", None) == P("model", None)


@pytest.mark.parametrize("shape,threshold", [
    ((15, 4), 0), ((64, 4), 0), ((64, 4), 1 << 30), ((64, 4), None),
    ((800_000, 4), None), ((2555, 8), 0)])
def test_plan_partition_spec_matches_reference(shape, threshold):
    mesh = _stub_mesh(data=2, model=16)
    got = plan_partition_spec(mesh, shape, threshold=threshold)
    want = RQ.plan_partition_spec(mesh, shape, threshold=threshold)
    assert got[0] == want[0] and got[1] == want[1]
    assert plan_partition_spec(None, shape, threshold=threshold) == (
        RQ.plan_partition_spec(None, shape, threshold=threshold))


def test_plan_placements_matches_reference_at_sf10():
    """SSB SF 10 P1's arms (part, supplier, date at l=4) on a (2, 4)
    mesh: the reference's reason, character for character."""
    mesh = _stub_mesh(data=2, model=4)
    shapes = [(800_000, 4), (20_000, 4), (2556, 4)]
    got = plan_placements(mesh, shapes)
    assert got == RQ.plan_placements(mesh, shapes)
    assert got[1] == (
        "place=[row-shard 800000 rows over model=4; 320000B < 1048576B: "
        "replicate small partial; 40896B < 1048576B: replicate small "
        "partial]")
    assert got[0] == (P("model", None), P(None, None), P(None, None))


def test_plan_query_records_partition_specs():
    rng = np.random.default_rng(0)
    L = rng.normal(size=(6, 4)).astype(np.float32)
    mesh = _stub_mesh(data=1, model=16)
    got = plan_query(LinearOperator(torch.from_numpy(L)), 1024, [64, 15],
                     platform="cpu", out_width=4, mesh=mesh,
                     shard_threshold_bytes=0)
    want = RQ.plan_query(RefLinear(jnp.asarray(L)), 1024, [64, 15],
                         out_width=4, mesh=mesh, shard_threshold_bytes=0)
    assert got.partition_specs == (P("model", None), P(None, None))
    assert got.partition_specs == want.partition_specs
    place = got.reason[got.reason.index("place=["):]
    assert place == want.reason[want.reason.index("place=["):]
    meshless = plan_query(LinearOperator(torch.from_numpy(L)), 1024,
                          [64, 15], platform="cpu", out_width=4)
    assert meshless.partition_specs is None and "place=" not in \
        meshless.reason


# -------------------------------------------------- per-shard PK indices
def test_shard_pk_index_matches_reference():
    rng = np.random.default_rng(0)
    pk = rng.permutation(64).astype(np.int32)
    pk[-5:] = PAD_KEY                          # a padded tail, as a table's
    for num_shards in (1, 2, 4, 8):
        got = shard_pk_index(torch.from_numpy(pk), num_shards)
        want = ref_shard_pk_index(jnp.asarray(pk), num_shards)
        assert got.num_shards == want.num_shards == num_shards
        assert got.rows_per_shard == want.rows_per_shard
        np.testing.assert_array_equal(to_np(got.sorted_pk),
                                      np.asarray(want.sorted_pk))
        np.testing.assert_array_equal(to_np(got.order),
                                      np.asarray(want.order))
        assert got.order.dtype == torch.int32
    x = rng.normal(size=(12, 3)).astype(np.float32)
    np.testing.assert_array_equal(to_np(shard_rows(torch.from_numpy(x), 4)),
                                  np.asarray(ref_shard_rows(jnp.asarray(x),
                                                            4)))


def test_shard_pk_index_probe_reconstructs_global():
    rng = np.random.default_rng(0)
    pk = torch.from_numpy(rng.permutation(64).astype(np.int32))
    sidx = shard_pk_index(pk, 4)
    assert sidx.num_shards == 4 and sidx.rows_per_shard == 16
    queries = torch.tensor([0, 7, 13, 63, 64, -1], dtype=torch.int32)
    hits = np.zeros(queries.shape[0], bool)
    resolved = np.zeros(queries.shape[0], np.int64)
    for s in range(4):
        fj = sidx.shard(s).probe(queries)
        found = to_np(fj.found)
        resolved[found] = to_np(fj.ptr)[found] + s * 16
        assert not np.any(hits & found), "two shards claimed one key"
        hits |= found
    full = to_np(pk)
    for i, k in enumerate(to_np(queries)):
        if 0 <= k < 64:
            assert hits[i] and full[resolved[i]] == k
        else:
            assert not hits[i]


def test_shard_pk_index_and_shard_rows_validate():
    pk = torch.arange(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="shard"):
        shard_pk_index(pk, 3)
    with pytest.raises(ValueError, match="shard"):
        shard_rows(torch.zeros((10, 2)), 4)
    assert tuple(shard_rows(torch.zeros((12, 2)), 4).shape) == (4, 3, 2)


# ------------------------------------------------------- sharded refresh
@pytest.mark.parametrize("shape", [(1, 8), (2, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("backend", ["fused", "nonfused"])
def test_refresh_sharded_serving_bit_exact(backend, shape):
    """Appends to both arms refresh a sharded runtime by delta: no new
    first calls, only the owning shard blocks indexed again, and the
    result ≡ a cold sharded runtime ≡ a cold single-device one (bit for
    bit), ≡ the reference's cold runtime to 1 ulp.  A sharded plan's
    ``predict_rows`` after its refresh ≡ a cold sharded plan's."""
    both = Both(ref_star(seed=9, n_d1=32, n_d2=16))
    ref_model = ref_models(seed=5)[0]
    rq = ref_query(ref_model, group=False)
    q = port_query(rq)
    mesh = _mesh(shape)
    kw = dict(backend=backend, buckets=(8,))
    rt = compile_serving(both.port, q, mesh=mesh, shard_threshold_bytes=0,
                         **kw)
    plan = compile_query(both.port, q, backend=backend, mesh=mesh,
                         shard_threshold_bytes=0)
    assert rt.sharded.num_sharded == 2
    reqs = {"fk1": np.array([0, 2, 65, 67, 99], np.int32),
            "fk2": np.array([0, 9, 16, 18, 3], np.int32)}
    rt.serve(reqs)
    n0 = rt.num_compiles
    old = rt.sharded.arms
    rng = np.random.default_rng(13)
    both.append("d1", d1_rows(rng, 6, start=32))
    both.append("d2", d2_rows(rng, 4, start=16))
    assert "delta" in rt.refresh()
    assert rt.num_compiles == n0 and rt.generation == 0
    # Appended rows [32, 38) of d1 and [16, 20) of d2: only their blocks
    # are new tensors; every other block is the one placed at compile.
    for j, (lo, hi) in enumerate(((32, 38), (16, 20))):
        rps = old[j].table.shape[0] // mesh.shape["model"]
        owners = set(range(lo // rps, -(-hi // rps)))
        for field in ("sorted_pk", "order", "dmask", "table"):
            before = getattr(old[j], field).parts
            after = getattr(rt.sharded.arms[j], field).parts
            assert before.keys() == after.keys()
            for (dev, s), t in after.items():
                assert (t is before[dev, s]) == (s not in owners), (
                    j, field, s)
    cold_sharded = compile_serving(both.port, q, mesh=mesh,
                                   shard_threshold_bytes=0, **kw)
    cold_single = compile_serving(both.port, q, serve_backend="torch", **kw)
    out = rt.serve(reqs)
    np.testing.assert_array_equal(to_np(out), to_np(cold_sharded.serve(reqs)))
    np.testing.assert_array_equal(to_np(out), to_np(cold_single.serve(reqs)))
    for a, b in zip(rt.sharded.arms, cold_sharded.sharded.arms):
        for field in ("sorted_pk", "order", "dmask", "table"):
            np.testing.assert_array_equal(to_np(getattr(a, field).full()),
                                          to_np(getattr(b, field).full()))
    ref_cold = RQ.compile_serving(both.ref, rq, backend=backend,
                                  serve_backend="jnp", buckets=(8,))
    assert_preds_equal(out, ref_cold.serve(reqs), exact=False)
    assert "delta" in plan.refresh()
    ids = torch.arange(both.port["fact"].capacity)
    cold_plan = compile_query(both.port, q, backend=backend, mesh=mesh,
                              shard_threshold_bytes=0)
    np.testing.assert_array_equal(to_np(plan.predict_rows(ids)),
                                  to_np(cold_plan.predict_rows(ids)))


def test_sharded_rebuild_after_capacity_growth():
    """An append past capacity rebuilds a sharded runtime (placement
    planned again from the grown table: its reason appears once) and
    recompiles a sharded plan; both equal cold single-device ones."""
    both = Both(ref_star(seed=9, n_d1=32, n_d2=16))
    q = port_query(ref_query(ref_models(seed=5)[0], group=False))
    mesh = _mesh((2, 4))
    rt = compile_serving(both.port, q, mesh=mesh, shard_threshold_bytes=0,
                         buckets=(8,))
    plan = compile_query(both.port, q, mesh=mesh, shard_threshold_bytes=0)
    rng = np.random.default_rng(1)
    both.append("d1", d1_rows(rng, 40, start=32))   # 72 rows > 48 slots
    assert rt.refresh().startswith("refresh=rebuild(capacity-growth:d1")
    assert plan.refresh().startswith("refresh=recompile(capacity-growth:d1")
    assert rt.generation == 1 and rt.plan.reason.count("place=[") == 1
    assert "row-shard 96 rows over model=4" in rt.plan.reason
    single = compile_serving(both.port, q, serve_backend="torch",
                             buckets=(8,))
    reqs = {"fk1": rng.integers(-1, 150, 40).astype(np.int32),
            "fk2": rng.integers(-1, 30, 40).astype(np.int32)}
    np.testing.assert_array_equal(to_np(rt.serve(reqs)),
                                  to_np(single.serve(reqs)))
    ids = torch.arange(both.port["fact"].capacity)
    flat = compile_query(both.port, q, serve_backend="torch")
    np.testing.assert_array_equal(to_np(plan.predict_rows(ids)),
                                  to_np(flat.predict_rows(ids)))


# ------------------------------------------------- scheduler and session
def test_sharded_runtime_through_scheduler_bit_exact():
    mesh = _mesh((1, 8))
    both = sched_star()
    rq = sched_query()
    q = port_query(rq)
    ref = compile_serving(both.port, q, buckets=(4, 16),
                          serve_backend="torch")
    rt = compile_serving(both.port, q, buckets=(4, 16), mesh=mesh,
                         shard_threshold_bytes=0)
    assert rt.sharded and rt.sharded.num_sharded == 1
    ref_rt = RQ.compile_serving(both.ref, rq, buckets=(4, 16))
    rng = np.random.default_rng(13)
    reqs = [sched_requests(rng, n) for n in (3, 16, 40)]   # 40: chunked
    with AdmissionScheduler(auto_start=False) as s:
        plan = s.register(rt)
        futs = [plan.submit(r, lane="batch" if r["fk1"].size > 16
                            else "interactive") for r in reqs]
        while not all(f.done() for f in futs):
            s.step()
        for f, r in zip(futs, reqs):
            got = f.result(0)
            np.testing.assert_array_equal(to_np(got), to_np(ref.serve(r)))
            assert_preds_equal(got, ref_rt.serve(r), exact=False)


def test_mesh_override_does_not_collide_in_plan_cache():
    """A per-call mesh override compiles a sibling plan, not the cached
    meshless one (and the other way round); meshes key by identity."""
    cat = port_catalog(ref_ssb_catalog())
    sess = Session(cat)
    q = QUERY_IR["P1.linear.year"]()
    meshless = sess.compile(q)
    m1 = make_serving_mesh((1, 1), device="cpu")
    sharded = sess.compile(q, mesh=m1)
    assert meshless is not sharded
    assert meshless.plan.partition_specs is None
    assert sharded.plan.partition_specs is not None
    assert sess.compile(q) is meshless
    assert sess.compile(q, mesh=m1) is sharded
    assert sess.compile(q, mesh=make_serving_mesh((1, 1),
                                                  device="cpu")) is not sharded


def test_session_mesh_and_run_all():
    """``Session(mesh=...)`` shards every plan and runtime it compiles (no
    pooled artifacts); ``run_all`` runs a sharded plan alone, and every
    result equals its ``run()`` and the meshless session's."""
    cat = port_catalog(ref_ssb_catalog())
    mesh = _mesh((2, 4))
    sess = Session(cat, mesh=mesh, shard_threshold_bytes=0)
    plain = Session(cat)
    names = ["P1.linear.year", "P3.tree.year", "Q1.1"]
    qs = [QUERY_IR[n]() for n in names]
    plans = [sess.compile(q) for q in qs]
    assert plans[0]._sp is not None and plans[0].plan.partition_specs
    assert plans[2]._sp is None       # no model head: nothing to place
    assert stack_key(plans[0]) is None and stack_key(plans[1]) is None
    assert sess.pool.stats()["entries"] == 0
    for got, p, q in zip(sess.run_all(qs), plans, qs):
        want = plain.compile(q).run()
        assert got.keys() == p.run().keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(to_np(got[k]), to_np(want[k]))
    rt = sess.serving(qs[0], buckets=(8, 32))
    assert rt.mesh is mesh and rt.buckets == (8, 32)
    assert sess.serving(qs[0], buckets=(8, 32)) is rt
    ids = torch.arange(40)
    np.testing.assert_array_equal(
        to_np(plans[0].predict_rows(ids)),
        to_np(plain.compile(qs[0]).predict_rows(ids)))


# -------------------------------------- a mesh of distinct device objects
def test_distinct_device_mesh_copies_and_matches():
    """``cpu:0`` … ``cpu:7`` are eight distinct devices to the port (a
    tensor moved between them is copied), so this mesh takes the code path
    of a mesh over eight cards — per-device blocks and replicas, copies
    into the merge — and still equals the single-device path."""
    cat = port_catalog(ref_ssb_catalog())
    devs = np.empty(8, dtype=object)
    devs[:] = [torch.device("cpu", i) for i in range(8)]
    mesh = Mesh(devs.reshape(2, 4), ("data", "model"))
    for name, backend in (("P1.linear.year", "fused"),
                          ("P3.tree.year", "nonfused")):
        q = QUERY_IR[name]()
        rt = compile_serving(cat, q, backend=backend, mesh=mesh,
                             shard_threshold_bytes=0, buckets=(8, 32))
        single = compile_serving(cat, q, backend=backend,
                                 serve_backend="torch", buckets=(8, 32))
        sharded = [a for a in rt.sharded.arms if a.is_sharded]
        replicated = [a for a in rt.sharded.arms if not a.is_sharded]
        assert sharded and replicated
        # A sharded arm: each block on the two devices of its shard; a
        # replicated one on all eight.
        assert len(sharded[0].table.parts) == 8
        assert {s for _, s in sharded[0].table.parts} == {0, 1, 2, 3}
        assert len(replicated[0].table.parts) == 8
        rng = np.random.default_rng(1)
        for n in (5, 32, 70):
            reqs = {a.fk_col: rng.integers(
                -2, int(cat[a.table].nvalid) + 4, n).astype(np.int32)
                for a in q.arms}
            np.testing.assert_array_equal(to_np(rt.serve(reqs)),
                                          to_np(single.serve(reqs)))
        plan = compile_query(cat, q, backend=backend, mesh=mesh,
                             shard_threshold_bytes=0)
        flat = compile_query(cat, q, backend=backend, serve_backend="torch")
        ids = torch.tensor([0, 3, 99, 2999, -1, 5000])
        np.testing.assert_array_equal(to_np(plan.predict_rows(ids)),
                                      to_np(flat.predict_rows(ids)))


# ------------------------------------ the reference's own sharded program
_REF_SCRIPT = r'''
import sys
import numpy as np
import jax
from repro.core.query import compile_query, compile_serving
from repro.data import QUERY_IR, generate_ssb, ssb_catalog
from repro.launch.mesh import make_serving_mesh

assert len(jax.devices()) == 8, jax.devices()
SIZES = (8, 32, 64)
cat = ssb_catalog(generate_ssb(sf=1, scale=0.0005, seed=5))
mesh = make_serving_mesh((2, 4))
rng = np.random.default_rng(17)
cap = cat["lineorder"].capacity
ids = np.array([0, 1, 17, 2999, cap + 7, -1, 5, 10 ** 7], np.int32)
out = {"ids": ids}
for name in ("P1.linear.year", "P3.tree.year"):
    q = QUERY_IR[name]()
    batches = []
    for n in SIZES:
        reqs = {}
        for arm in q.arms:
            n_live = int(cat[arm.table].nvalid)
            reqs[arm.fk_col] = rng.integers(-2, n_live + 4,
                                            n).astype(np.int32)
        batches.append(reqs)
    for b in ("fused", "nonfused"):
        tag = f"{name}|{b}"
        rt = compile_serving(cat, q, backend=b, mesh=mesh,
                             shard_threshold_bytes=0, buckets=(8, 32))
        cq = compile_query(cat, q, backend=b, mesh=mesh,
                           shard_threshold_bytes=0)
        for i, reqs in enumerate(batches):
            for k, v in reqs.items():
                out[f"{tag}|req{i}|{k}"] = v
            out[f"{tag}|serve{i}"] = np.asarray(rt.serve(reqs))
        out[f"{tag}|rows"] = np.asarray(cq.predict_rows(ids))
        for what, plan, sp in (("rt", rt.plan, rt.sharded),
                               ("cq", cq.plan, cq._sp)):
            out[f"{tag}|{what}|specs"] = np.array(repr(
                [tuple(s) for s in plan.partition_specs]))
            out[f"{tag}|{what}|place"] = np.array(
                plan.reason[plan.reason.rindex("place=["):])
            out[f"{tag}|{what}|nbytes"] = np.array(sp.nbytes_per_device())
np.savez(sys.argv[1], **out)
'''


def test_reference_sharded_program_agrees(tmp_path):
    """The reference's sharded P1 and P3 (fused and nonfused, mesh (2, 4),
    ``shard_threshold_bytes=0``, 8 forced host devices) against the
    port's on a virtual (2, 4) mesh: specs, ``place=[...]`` reasons and
    ``nbytes_per_device()`` equal; sharded ``serve`` and ``predict_rows``
    at the parity rules (exact for trees, 1 ulp for linear heads) — save
    P3's out-of-range ``predict_rows`` rows, NaN in the reference's
    sharded forward and the single-device fill in the port's (ROADMAP
    C3), which are held to the port's single-device plan instead.  The
    batches fill their buckets (8, 32, and 64 in two chunks): with the
    installed jax the reference's sharded ``serve`` raises a
    ``ShardingTypeError`` on a padded batch (ROADMAP C4)."""
    dump = tmp_path / "ref_sharded.npz"
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(dump)],
                          env=env, cwd=tmp_path, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = np.load(dump)
    cat = port_catalog(ref_ssb_catalog())
    mesh = _mesh((2, 4))
    ids = torch.from_numpy(ref["ids"].astype(np.int64))
    cap = cat["lineorder"].capacity
    outside = [4, 7]
    assert all(not -cap <= int(ids[i]) < cap for i in outside)
    for name in ("P1.linear.year", "P3.tree.year"):
        q = QUERY_IR[name]()
        tree = name.startswith("P3")
        for b in ("fused", "nonfused"):
            tag = f"{name}|{b}"
            rt = compile_serving(cat, q, backend=b, mesh=mesh,
                                 shard_threshold_bytes=0, buckets=(8, 32))
            cq = compile_query(cat, q, backend=b, mesh=mesh,
                               shard_threshold_bytes=0)
            for what, plan, sp in (("rt", rt.plan, rt.sharded),
                                   ("cq", cq.plan, cq._sp)):
                assert repr([tuple(s) for s in plan.partition_specs]) == \
                    str(ref[f"{tag}|{what}|specs"]), (tag, what)
                assert plan.reason[plan.reason.rindex("place=["):] == \
                    str(ref[f"{tag}|{what}|place"]), (tag, what)
                assert sp.nbytes_per_device() == int(
                    ref[f"{tag}|{what}|nbytes"]), (tag, what)
            for i in range(3):
                reqs = {a.fk_col: ref[f"{tag}|req{i}|{a.fk_col}"]
                        for a in q.arms}
                assert_preds_equal(rt.serve(reqs), ref[f"{tag}|serve{i}"],
                                   exact=tree)
            got = to_np(cq.predict_rows(ids))
            want = ref[f"{tag}|rows"]
            inside = [i for i in range(len(ids)) if i not in outside]
            assert_preds_equal(got[inside], want[inside], exact=tree)
            single = compile_query(cat, q, backend=b, serve_backend="torch")
            np.testing.assert_array_equal(got, to_np(single.predict_rows(ids)))
            if tree:
                assert np.isnan(want[outside]).all()      # C3
                assert np.isfinite(got[outside]).all()
            else:
                np.testing.assert_array_equal(got[outside], want[outside])
