"""Port parity: sharded serving (``repro_torch.core.query.sharding``) against
``tests/test_sharded_serving.py``, case by case.

The reference runs its multi-device cases on 8 forced host devices; the
port's counterpart is a *virtual* mesh of 8 positions on ``cpu``
(``make_serving_mesh(shape, device="cpu")``), which runs the whole sharded
program — every shard's probe and gather, the merge over the model axis,
the split over the data axis — in one process.

The contract:
  * sharded ``serve`` and ``predict_rows`` on (1,8), (2,4) and (8,1) equal
    the port's single-device plain path (serve backend ``"torch"``) bit for
    bit, out-of-range ids included (ROADMAP C3: the port keeps its
    single-device fill rules there, where the reference's sharded forward
    writes NaN rows for every head).  Nonfused linear heads run their
    matmul per data-parallel row, so batch shape may change their rounding:
    they are held to 1 ulp (rtol 1e-6, ``torch_parity.assert_preds_equal``);
  * they equal the reference's single-device results at the parity rules
    (exact for tree heads, 1 ulp for linear heads, whose partials are
    prefused in another framework);
  * no bucket's first call happens twice across ragged batches; buckets
    round up to multiples of the data-parallel size; placement replicates
    below the byte threshold, row-shards above it and replicates a row
    count that does not divide the model axis.

The planner, index and mesh cases, the refresh, scheduler and session
cases, and the run against the reference's own sharded program are in
``tests/test_torch_sharding_b.py``.
"""
import numpy as np
import pytest
import torch

import repro.core.query as RQ
from repro.data import QUERY_IR as REF_QUERY_IR
from repro.data import predictive_query_names as ref_predictive_names
from repro_torch.core.query import (compile_query, compile_serving,
                                    requests_from_rows)
from repro_torch.data import QUERY_IR
from repro_torch.launch.mesh import make_serving_mesh
from torch_parity import (assert_preds_equal, is_tree, port_catalog,
                          ref_ssb_catalog, to_np)

PRED_NAMES = ref_predictive_names()
BUCKETS = (8, 32)
MESH_SHAPES = [(1, 8), (2, 4), (8, 1)]
# Sizes covering every bucket (exact and padded) and the chunked path.
BATCH_SIZES = (3, 8, 20, 32, 70)


@pytest.fixture(scope="module")
def ref_cat():
    return ref_ssb_catalog()


@pytest.fixture(scope="module")
def cat(ref_cat):
    return port_catalog(ref_cat)


@pytest.fixture(scope="module")
def cache():
    """Runtimes and plans, compiled once per option set in this module."""
    return {}


def _mesh(shape):
    return make_serving_mesh(shape, device="cpu")


def _runtime(cache, cat, name, *, shape=None, **kw):
    kw.setdefault("buckets", BUCKETS)
    key = ("serve", name, shape, tuple(sorted(kw.items())))
    if key not in cache:
        mesh = None if shape is None else _mesh(shape)
        if mesh is None:
            kw.setdefault("serve_backend", "torch")
        cache[key] = compile_serving(cat, QUERY_IR[name](), mesh=mesh, **kw)
    return cache[key]


def _ref_runtime(cache, ref_cat, name, backend):
    key = ("ref", name, backend)
    if key not in cache:
        cache[key] = RQ.compile_serving(
            ref_cat, REF_QUERY_IR[name](), backend=backend,
            serve_backend="jnp", buckets=BUCKETS)
    return cache[key]


def _random_requests(q, cat, n, rng):
    """Live dimension keys mixed with misses (the reference's helper)."""
    reqs = {}
    for arm in q.arms:
        dim = cat[arm.table]
        live = to_np(dim.key(arm.pk_col))[:int(dim.nvalid)]
        keys = rng.choice(live, size=n)
        miss = rng.random(n) < 0.25
        keys = np.where(miss, rng.integers(-3, 0, size=n), keys)
        reqs[arm.fk_col] = keys.astype(np.int32)
    return reqs


def _exact_vs_single(name, backend):
    """Sharded ≡ single-device bit for bit, save nonfused linear heads."""
    return backend == "fused" or is_tree(name)


# --------------------------------------------------- single-position mesh
@pytest.mark.parametrize("backend", ["fused", "nonfused"])
def test_sharded_serving_single_device_mesh(backend, cat, cache):
    """The sharded program runs on a (1, 1) mesh too."""
    name = PRED_NAMES[0]
    q = QUERY_IR[name]()
    ref = _runtime(cache, cat, name, backend=backend)
    sh = compile_serving(cat, q, backend=backend, mesh=_mesh((1, 1)),
                         shard_threshold_bytes=0, buckets=BUCKETS)
    assert sh.mesh is sh.sharded.mesh and sh.mesh.size == 1
    assert sh.sharded is not None and sh.sharded.num_sharded > 0
    assert sh.serve_backend == "torch"
    rng = np.random.default_rng(3)
    for n in BATCH_SIZES:
        reqs = _random_requests(q, cat, n, rng)
        np.testing.assert_array_equal(to_np(sh.serve(reqs)),
                                      to_np(ref.serve(reqs)))


def test_sharded_serving_rejects_kernel(cat, ref_cat):
    """``"kernel"`` beside a mesh raises (the reference's ``"pallas"``
    does); ``"auto"`` resolves to the plain gathers."""
    q = QUERY_IR[PRED_NAMES[0]]()
    mesh = _mesh((1, 1))
    with pytest.raises(ValueError, match="kernel"):
        compile_serving(cat, q, mesh=mesh, serve_backend="kernel")
    with pytest.raises(ValueError, match="kernel"):
        compile_query(cat, q, mesh=mesh, serve_backend="kernel")
    with pytest.raises(ValueError, match="pallas"):
        RQ.compile_serving(ref_cat, REF_QUERY_IR[PRED_NAMES[0]](),
                           mesh=object(), serve_backend="pallas")
    assert compile_query(cat, q, mesh=mesh).serve_backend == "torch"


# ------------------------------------------------- multi-position bit-exact
@pytest.mark.parametrize("shape", MESH_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("backend", ["fused", "nonfused"])
@pytest.mark.parametrize("name", PRED_NAMES)
def test_sharded_matches_single_device(name, backend, shape, cat, ref_cat,
                                       cache):
    """Sharded serving ≡ the port's single-device plain runtime (bit for
    bit) and ≡ the reference's single-device runtime (parity rules)."""
    q = QUERY_IR[name]()
    single = _runtime(cache, cat, name, backend=backend)
    sh = _runtime(cache, cat, name, shape=shape, backend=backend,
                  shard_threshold_bytes=0)
    want_ref = _ref_runtime(cache, ref_cat, name, backend)
    rng = np.random.default_rng(11)
    for n in BATCH_SIZES:
        reqs = _random_requests(q, cat, n, rng)
        got = sh.serve(reqs)
        assert got.shape == (n, sh.out_width)
        assert_preds_equal(got, single.serve(reqs),
                           exact=_exact_vs_single(name, backend))
        assert_preds_equal(got, want_ref.serve(reqs), exact=is_tree(name))


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_no_recompile_across_ragged_batches(shape, cat):
    """One first call per bucket for life, as the single-device runtime."""
    q = QUERY_IR["P1.linear.year"]()
    runtime = compile_serving(cat, q, buckets=BUCKETS, mesh=_mesh(shape),
                              shard_threshold_bytes=0)
    rng = np.random.default_rng(0)
    sizes = [1, 3, 8, 9, 20, 31, 32, 33, 70, 100]
    for n in sizes:
        out = runtime.serve(_random_requests(q, cat, n, rng))
        assert out.shape == (n, runtime.out_width)
    assert runtime.num_compiles == len(BUCKETS)
    assert runtime.jit_cache_size() is None
    for n in sizes:
        runtime.serve(_random_requests(q, cat, n, rng))
    assert runtime.num_compiles == len(BUCKETS)
    assert runtime.generation == 0


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("backend", ["fused", "nonfused"])
def test_sharded_predict_rows_matches(backend, shape, cat, ref_cat, cache):
    """``compile_query(mesh=...)`` ``predict_rows`` ≡ the single-device
    plain plan (bit for bit) and ≡ the reference's single-device plan."""
    name = ("P3.tree.year" if backend == "nonfused"
            else "P2.linear.select.scalar")
    q = QUERY_IR[name]()
    single = compile_query(cat, q, backend=backend, serve_backend="torch")
    sh = compile_query(cat, q, backend=backend, mesh=_mesh(shape),
                       shard_threshold_bytes=0)
    assert sh.plan.partition_specs is not None
    assert sh.serve_backend == "torch"
    assert "place=[" in sh.plan.reason
    ids = torch.tensor([0, 1, 5, 17, 100, 2999])
    got = sh.predict_rows(ids)
    np.testing.assert_array_equal(to_np(got), to_np(single.predict_rows(ids)))
    key = ("ref_plan", name, backend)
    if key not in cache:
        cache[key] = RQ.compile_query(ref_cat, REF_QUERY_IR[name](),
                                      backend=backend, serve_backend="jnp")
    assert_preds_equal(got, cache[key].predict_rows(to_np(ids)),
                       exact=is_tree(name))


@pytest.mark.parametrize("name,backend", [
    ("P1.linear.year", "fused"), ("P1.linear.year", "nonfused"),
    ("P3.tree.year", "fused"), ("P3.tree.year", "nonfused")])
def test_sharded_predict_rows_out_of_range(name, backend, cat, ref_cat):
    """Out-of-range row ids keep the single-device fill rules even when
    every arm is row-sharded: NaN rows for linear heads (as the reference,
    sharded or not), and for trees what the single-device plain path gives
    (zero rows fused, the all-false leaf nonfused), where the reference's
    sharded forward writes NaN (ROADMAP C3)."""
    q = QUERY_IR[name]()
    single = compile_query(cat, q, backend=backend, serve_backend="torch")
    sh = compile_query(cat, q, backend=backend, mesh=_mesh((1, 8)),
                       shard_threshold_bytes=0)
    cap = cat[q.fact].capacity
    ids = torch.tensor([0, cap + 7, 10**7, -1, 5, -cap - 1])
    got, want = to_np(sh.predict_rows(ids)), to_np(single.predict_rows(ids))
    np.testing.assert_array_equal(got, want)
    outside = [1, 2, 5]
    if is_tree(name):
        assert np.isfinite(got[outside]).all()
    else:
        assert np.isnan(got[outside]).all()
    # The reference's single-device plain plan agrees with the port there.
    ref = RQ.compile_query(ref_cat, REF_QUERY_IR[name](), backend=backend,
                           serve_backend="jnp", rewrite="off")
    ref_got = np.asarray(ref.predict_rows(to_np(ids)))
    np.testing.assert_array_equal(np.isnan(got[outside]),
                                  np.isnan(ref_got[outside]))


def test_sharded_serving_matches_predict_rows(cat, cache):
    """serve ≡ predict_rows survives sharding end to end."""
    name = "P1.linear.year"
    q = QUERY_IR[name]()
    compiled = compile_query(cat, q, backend="fused", mesh=_mesh((2, 4)),
                             shard_threshold_bytes=0)
    runtime = _runtime(cache, cat, name, shape=(2, 4), backend="fused",
                       shard_threshold_bytes=0)
    fact = cat[q.fact]
    ok = fact.valid_mask()
    for p in q.fact_preds:
        ok = ok & p.mask(fact)
    ids = torch.nonzero(ok).flatten()[:50]
    got = runtime.serve(requests_from_rows(fact, q, ids))
    np.testing.assert_array_equal(to_np(got),
                                  to_np(compiled.predict_rows(ids)))


def test_bucket_rounding_to_dp_multiples(cat):
    """Buckets round up to data-parallel multiples so padded batches
    split evenly."""
    q = QUERY_IR["P1.linear.year"]()
    runtime = compile_serving(cat, q, buckets=(3, 9), mesh=_mesh((8, 1)))
    assert runtime.buckets == (8, 16)
    out = runtime.serve(
        _random_requests(q, cat, 5, np.random.default_rng(0)))
    assert out.shape == (5, runtime.out_width)
    assert compile_serving(cat, q, buckets=(3, 9),
                           mesh=_mesh((2, 4))).buckets == (4, 10)


def test_placement_threshold_and_divisibility(cat):
    """Placement: small → replicate; large → shard; non-divisible row
    counts → replicate (``safe_spec``)."""
    q = QUERY_IR["P1.linear.year"]()
    mesh = _mesh((2, 4))
    repl = compile_serving(cat, q, mesh=mesh, shard_threshold_bytes=1 << 40)
    assert all(spec[0] is None for spec in repl.plan.partition_specs)
    assert repl.sharded.num_sharded == 0
    sh = compile_serving(cat, q, mesh=mesh, shard_threshold_bytes=0)
    rows = {a.fk_col: cat[a.table].capacity for a in q.arms}
    for arm, spec in zip(q.arms, sh.plan.partition_specs):
        expected = "model" if rows[arm.fk_col] % 4 == 0 else None
        assert spec[0] == expected, (arm.fk_col, spec)
    assert 0 < sh.sharded.num_sharded < len(q.arms)
    assert sh.sharded.nbytes_per_device() < repl.sharded.nbytes_per_device()
    # The default threshold (1 MiB) replicates every partial at this scale.
    default = compile_serving(cat, q, mesh=mesh)
    assert default.sharded.num_sharded == 0
    assert "B < 1048576B: replicate small partial" in default.plan.reason
