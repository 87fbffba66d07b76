"""The data lifecycle of the port (``Catalog``; append, update, delete,
compact; delta ``refresh`` of compiled queries and serving runtimes)
against the JAX reference, case by case after ``tests/test_incremental.py``
and the deletion cases of ``tests/test_outofcore.py``.

Every case builds one reference catalog from a seed with numpy, carries it
to the port through ``repro_torch.interop`` and applies the same mutations
to both.  Then:

* the port's refreshed plan or runtime equals the port's cold compile on
  the same catalog **bit for bit** (``run()``, ``predict_rows``, ``serve``,
  the prefused partials);
* it equals the reference's refreshed one: the decision line exactly;
  rows, groups, counts and tree-head prediction sums (integer-valued)
  exactly; every other aggregate within rtol 1e-5 and linear-head
  predictions within rtol 1e-6 (1 ulp), as ``tests/torch_parity.py``
  states — float sums taken in another framework, in another order.

The reference plans are compiled with ``rewrite="off"`` (the port has no
rewrite engine).  The cases that need ``Session``
(``test_session_cache_never_serves_stale_partials``,
``test_session_refresh_eager``, the read-only ``Session`` shim) are in
``tests/test_torch_session.py``; the sharded-serving refresh
(``test_refresh_sharded_serving_bit_exact``) is in
``tests/test_torch_sharding_b.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.query as RQ
from repro.core.fusion import LinearOperator, random_tree
from repro.core.laq import Catalog as RefCatalog
from repro.core.laq import DomainCache as RefDomainCache
from repro.core.laq import Table as RefTable
from repro.core.laq import pk_index as ref_pk_index
from repro_torch.core.laq import (PAD_GROUP, PAD_KEY, Catalog,
                                  CatalogReadOnlyError, DomainCache,
                                  groupby_codes, pk_index)
from repro_torch.core.query import compile_query, compile_serving
from torch_parity import (Both, assert_same, check_plan, check_runtime,
                          d1_rows, d2_rows, port_catalog, port_query,
                          port_tables, ref_compile, ref_query, ref_star,
                          to_np)
from torch_parity import ref_models as models


# ------------------------------------------- append → refresh ≡ cold rebuild
@pytest.mark.parametrize("backend", ["fused", "nonfused"])
@pytest.mark.parametrize("agg_backend", ["segment", "matmul"])
def test_refresh_equals_cold_rebuild_run(backend, agg_backend):
    for model in models():
        both = Both(ref_star(seed=7))
        rq = ref_query(model, group=True)
        q = port_query(rq)
        kw = dict(backend=backend, agg_backend=agg_backend)
        want = ref_compile(both.ref, rq, **kw)
        got = compile_query(both.port, q, **kw)
        rng = np.random.default_rng(11)
        both.append("d1", d1_rows(rng, 5, start=24))
        both.append("d2", d2_rows(rng, 3, start=10))
        both.append("fact", {"fk1": [1, 49, 3], "fk2": [10, 12, 0],
                             "val": [0.5, -0.5, 1.5]})
        line = got.refresh()
        assert line == want.refresh() == (
            "refresh=delta(d1+1,d2+1,fact+1; shapes kept, jit cache "
            "reused)")
        cold = compile_query(both.port, q, **kw)
        check_plan(got, want, cold, rq,
                   ids=np.arange(0, 67, 5, dtype=np.int32))


@pytest.mark.parametrize("backend", ["fused", "nonfused"])
def test_refresh_equals_cold_rebuild_serving(backend):
    for model in models(seed=3):
        both = Both(ref_star(seed=8))
        rq = ref_query(model, group=False)
        q = port_query(rq)
        want = RQ.compile_serving(both.ref, rq, backend=backend,
                                  buckets=(8, 32))
        got = compile_serving(both.port, q, backend=backend, buckets=(8, 32))
        reqs = {"fk1": np.array([0, 2, 49, 51, 99], np.int32),
                "fk2": np.array([0, 9, 10, 12, 3], np.int32)}
        got.serve(reqs)
        want.serve(reqs)
        n0 = got.num_compiles
        rng = np.random.default_rng(12)
        both.append("d1", d1_rows(rng, 5, start=24))
        both.append("d2", d2_rows(rng, 3, start=10))
        line = got.refresh()
        assert line == want.refresh() == (
            "refresh=delta(d1+1,d2+1; shapes kept, 0 new compiles)")
        assert got.num_compiles == n0, "delta refresh must add no compile"
        cold = compile_serving(both.port, q, backend=backend,
                               buckets=(8, 32))
        check_runtime(got, want, cold, rq, reqs)


# Fixed draws of the reference's hypothesis property
# (test_property_append_refresh_equals_cold): seed, split, backend,
# agg_backend, tree, group.
APPEND_CASES = [
    (0, 0.1, "fused", "segment", False, True),
    (17, 0.5, "fused", "matmul", True, True),
    (4242, 0.9, "nonfused", "segment", True, False),
    (65535, 0.33, "nonfused", "matmul", False, True),
    (123, 0.75, "fused", "segment", True, False),
    (999, 0.2, "nonfused", "segment", False, False),
]


@pytest.mark.parametrize("case", APPEND_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_append_refresh_equals_cold(case):
    """Build on a prefix of the dimension rows, append the rest, refresh:
    the port equals its cold compile on the full catalog bit for bit, and
    the reference's refreshed plan, for run(), predict_rows() and
    serving."""
    seed, split, backend, agg_backend, tree, group = case
    rng = np.random.default_rng(seed)
    n_d1, n_d2 = 20, 12
    m1 = max(1, min(n_d1 - 1, int(n_d1 * split)))
    m2 = max(1, min(n_d2 - 1, int(n_d2 * split)))
    d1 = {"pk": np.arange(n_d1) * 2, "a": rng.normal(size=n_d1),
          "b": rng.normal(size=n_d1)}
    d2 = {"pk2": np.arange(n_d2), "c": rng.normal(size=n_d2),
          "g": rng.integers(0, 4, n_d2)}
    f = {"fk1": rng.integers(0, 2 * n_d1 + 4, 48),
         "fk2": rng.integers(0, n_d2 + 2, 48),
         "val": rng.normal(size=48)}
    model = (random_tree(rng, 3, depth=2) if tree
             else LinearOperator(jnp.asarray(
                 rng.normal(size=(3, 2)).astype(np.float32))))

    def tables(prefix1, prefix2):
        return RefCatalog({
            "d1": RefTable.from_columns(
                "d1", {k: v[:prefix1] for k, v in d1.items()},
                key_cols=("pk",), capacity=n_d1),
            "d2": RefTable.from_columns(
                "d2", {k: v[:prefix2] for k, v in d2.items()},
                key_cols=("pk2", "g"), capacity=n_d2),
            "fact": RefTable.from_columns("fact", f,
                                          key_cols=("fk1", "fk2")),
        })

    rq = ref_query(model, group=group)
    q = port_query(rq)
    kw = dict(backend=backend, agg_backend=agg_backend)
    both = Both(tables(m1, m2))
    want = ref_compile(both.ref, rq, **kw)
    got = compile_query(both.port, q, **kw)
    rt_want = RQ.compile_serving(both.ref, rq, backend=backend,
                                 buckets=(16,))
    rt = compile_serving(both.port, q, backend=backend, buckets=(16,))
    both.append("d1", {k: v[m1:] for k, v in d1.items()})
    both.append("d2", {k: v[m2:] for k, v in d2.items()})
    assert got.refresh() == want.refresh()
    assert rt.refresh() == rt_want.refresh()
    full = port_catalog(tables(n_d1, n_d2))
    check_plan(got, want, compile_query(full, q, **kw), rq,
               ids=np.arange(48, dtype=np.int32))
    reqs = {"fk1": f["fk1"][:16], "fk2": f["fk2"][:16]}
    check_runtime(rt, rt_want, compile_serving(full, q, backend=backend,
                                               buckets=(16,)), rq, reqs)


# ------------------------------------------------- fallback + update paths
def test_capacity_growth_falls_back_with_named_reason():
    both = Both(ref_star(seed=25, slack=2))
    rq = ref_query(models(seed=6)[0], group=True)
    q = port_query(rq)
    want, got = ref_compile(both.ref, rq), compile_query(both.port, q)
    rt_want = RQ.compile_serving(both.ref, rq, buckets=(8,))
    rt = compile_serving(both.port, q, buckets=(8,))
    rt.serve({"fk1": np.zeros(3, np.int32), "fk2": np.zeros(3, np.int32)})
    rng = np.random.default_rng(26)
    both.append("d1", d1_rows(rng, 8, start=24))   # overflows slack=2: grow
    assert both.port.deltas_since("d1", 0)[0].grew
    assert both.port["d1"].capacity == both.ref["d1"].capacity == 52
    line = got.refresh()
    assert line == want.refresh() == "refresh=recompile(capacity-growth:d1)"
    assert "capacity-growth" in got.plan.reason
    line = rt.refresh()
    assert line == rt_want.refresh() == (
        "refresh=rebuild(capacity-growth:d1; replanned, jit cache reset)")
    assert rt.num_compiles == 0 and rt.generation == 1
    check_plan(got, want, compile_query(both.port, q), rq)
    reqs = {"fk1": np.array([1, 53], np.int32),
            "fk2": np.array([0, 1], np.int32)}
    check_runtime(rt, rt_want, compile_serving(both.port, q, buckets=(8,)),
                  rq, reqs)


def test_update_column_refreshes_partials():
    both = Both(ref_star(seed=27))
    rq = ref_query(models(seed=8)[0], group=False)
    q = port_query(rq)
    want = ref_compile(both.ref, rq, backend="fused")
    got = compile_query(both.port, q, backend="fused")
    rt_want = RQ.compile_serving(both.ref, rq, backend="fused", buckets=(8,))
    rt = compile_serving(both.port, q, backend="fused", buckets=(8,))
    both.update_column("d1", "a", [0, 3, 5], [2.0, -3.0, 0.25])
    assert got.refresh() == want.refresh()
    assert "delta" in rt.refresh() and "delta" in rt_want.refresh()
    check_plan(got, want, compile_query(both.port, q, backend="fused"), rq,
               ids=np.arange(0, 64, 3, dtype=np.int32))
    reqs = {"fk1": np.array([0, 6, 10], np.int32),
            "fk2": np.array([0, 1, 2], np.int32)}
    check_runtime(rt, rt_want, compile_serving(both.port, q, backend="fused",
                                               buckets=(8,)), rq, reqs)


def test_update_key_column_rejected():
    both = Both(ref_star(seed=28))
    with pytest.raises(ValueError, match="key column"):
        both.ref.update_column("d1", "pk", [0], [999])
    with pytest.raises(ValueError, match="key column"):
        both.port.update_column("d1", "pk", [0], [999])
    assert both.port.version("d1") == 0


def test_append_is_transactional():
    both = Both(ref_star(seed=29))
    cat = both.port
    v0, t0 = cat.version("d1"), cat["d1"]
    with pytest.raises(ValueError, match="missing columns"):
        cat.append("d1", {"pk": [999]})
    with pytest.raises(ValueError, match="ragged"):
        cat.append("d1", {"pk": [999], "a": [1.0, 2.0], "b": [0.0]})
    assert cat.version("d1") == v0 and cat["d1"] is t0


def test_mutations_keep_the_old_table():
    """Value semantics: a mutation returns a new Table and leaves the old
    one's tensors untouched, so a plan that has not refreshed computes from
    its own version."""
    both = Both(ref_star(seed=30))
    cat = both.port
    q = port_query(ref_query(models(seed=1)[0], group=True))
    plan = compile_query(cat, q, backend="fused")
    before = plan.run()
    old = cat["d1"]
    snap = (old.matrix.clone(), old.key("pk").clone())
    rng = np.random.default_rng(31)
    cat.append("d1", d1_rows(rng, 3, start=24))
    cat.update_column("d1", "a", [1, 2], [5.0, 6.0])
    cat.delete_rows("d1", [0, 4])
    assert old.deleted is None and int(old.nvalid) == 24
    assert_same(old.matrix, snap[0])
    assert_same(old.key("pk"), snap[1])
    assert_same(plan.run(), before)          # not refreshed: old version
    assert "delta" in plan.refresh()
    assert_same(plan.run(), compile_query(cat, q, backend="fused").run())


# ------------------------------------------------- stats reset, generations
def test_latency_stats_reset_across_refresh():
    both = Both(ref_star(seed=31))
    q = port_query(ref_query(models(seed=9)[0], group=False))
    rt = compile_serving(both.port, q, buckets=(8,), sync_stats=True)
    reqs = {"fk1": np.array([0, 2], np.int32),
            "fk2": np.array([0, 1], np.int32)}
    for _ in range(3):
        rt.serve(reqs)
    stats = rt.latency_stats()
    assert stats[8]["count"] == 2 and "compile_ms" in stats[8]
    n0 = rt.num_compiles
    rng = np.random.default_rng(32)
    both.append("d1", d1_rows(rng, 2, start=24))
    rt.refresh()
    post = rt.latency_stats()
    assert post[8]["count"] == 0 and "p50" not in post[8], \
        "post-refresh percentiles must not mix pre-refresh samples"
    # The compile record is per generation: a delta refresh keeps it.
    assert post[8]["compile_ms"] == stats[8]["compile_ms"]
    assert rt.num_compiles == n0, "delta refresh adds no compile"
    rt.serve(reqs)
    assert rt.num_compiles == n0, "refreshed state serves without one"
    assert rt.latency_stats()[8]["count"] == 1


def test_compile_records_survive_rebuild_per_generation():
    both = Both(ref_star(seed=33, slack=2))
    q = port_query(ref_query(models(seed=10)[0], group=False))
    rt = compile_serving(both.port, q, buckets=(8,))
    reqs = {"fk1": np.array([0, 2], np.int32),
            "fk2": np.array([0, 1], np.int32)}
    rt.serve(reqs)
    assert rt.generation == 0
    gen0 = rt.compile_history()[0][8]
    rng = np.random.default_rng(34)
    both.append("d1", d1_rows(rng, 6, start=24))   # past the capacity
    rt.refresh()                                   # rebuild: new generation
    rt.serve(reqs)                                 # bucket 8's first call
    assert rt.generation == 1
    hist = rt.compile_history()
    assert len(hist) == 2 and hist[0][8] == gen0, \
        "a rebuild must archive, not overwrite, generation 0's records"
    assert rt.latency_stats()[8]["compile_ms"] == hist[1][8]
    assert rt.explain().as_dict()["extras"]["generation"] == 1


# ----------------------------------------------------------- DomainCache
def test_domain_cache_refresh_grows_instead_of_truncating():
    got_cache, want_cache = DomainCache(), RefDomainCache()
    keys = np.arange(8, dtype=np.int32)
    dom = got_cache.get_or_build([("r", "k")], [torch.from_numpy(keys)],
                                 size=8)
    want_cache.get_or_build([("r", "k")], [jnp.asarray(keys)], size=8)
    assert dom.shape == (8,)
    new = np.arange(100, 106, dtype=np.int32)
    merged = got_cache.refresh([("r", "k")], torch.from_numpy(new))
    want = want_cache.refresh([("r", "k")], jnp.asarray(new))
    assert_same(merged, np.asarray(want))
    assert merged.shape[0] == 16            # geometric growth, not 8
    live = to_np(merged)[to_np(merged) != PAD_KEY]
    assert set(live.tolist()) == set(range(8)) | set(range(100, 106))
    with pytest.raises(ValueError, match="capacity"):
        got_cache.refresh([("r", "k")],
                          torch.arange(200, 220, dtype=torch.int32),
                          grow=False)
    assert (got_cache.hits, got_cache.misses) == (0, 1)
    got_cache.get_or_build([("r", "k")], [], size=8)
    assert got_cache.hits == 1


def test_domain_cache_refresh_table_hook():
    cache = DomainCache()
    cache.get_or_build([("d1", "pk")],
                       [torch.arange(4, dtype=torch.int32)], size=8)
    both = Both(ref_star(seed=33))
    both.port.domain_cache = cache
    rng = np.random.default_rng(34)
    both.port.append("d1", d1_rows(rng, 2, start=24))
    dom = to_np(cache.get_or_build([("d1", "pk")], [], size=8))
    assert 49 in dom.tolist()               # appended key merged in
    assert cache.refresh_table("d2", {"pk2": torch.tensor([1])}) == 0


# ------------------------------------------------------ PKIndex.extend
def test_pk_index_extend_matches_cold_rebuild():
    rng = np.random.default_rng(41)
    keys = rng.permutation(np.arange(0, 200, 3))[:40].astype(np.int32)
    cap = 64
    pk = np.full(cap, PAD_KEY, np.int32)
    pk[:30] = keys[:30]
    idx = pk_index(torch.from_numpy(pk))
    assert idx.n_live == 30
    pk2 = pk.copy()
    pk2[30:40] = keys[30:40]
    ext = idx.extend(keys[30:40], np.arange(30, 40))
    cold = pk_index(torch.from_numpy(pk2))
    want = ref_pk_index(jnp.asarray(pk)).extend(keys[30:40],
                                                np.arange(30, 40))
    for got_a, cold_a, want_a in ((ext.sorted_pk, cold.sorted_pk,
                                   want.sorted_pk),
                                  (ext.order, cold.order, want.order)):
        assert got_a.dtype == torch.int32
        assert_same(got_a, cold_a)
        assert_same(got_a, np.asarray(want_a))
    assert ext.n_live == 40
    with pytest.raises(ValueError, match="uniqueness"):
        ext.extend(keys[:1], np.array([40]))
    with pytest.raises(ValueError, match="uniqueness"):
        ext.extend(np.array([1001, 1001], np.int32), np.array([40, 41]))
    with pytest.raises(ValueError, match="capacity"):
        ext.extend(np.arange(1000, 1030, dtype=np.int32), np.arange(30))
    # From an empty index, PAD_KEY entries skipped.
    empty = pk_index(torch.full((8,), PAD_KEY, dtype=torch.int32))
    got = empty.extend(np.array([5, PAD_KEY, 3], np.int32),
                       np.array([0, 1, 2]))
    assert to_np(got.sorted_pk)[:2].tolist() == [3, 5]
    assert to_np(got.order).tolist() == [2, 0, 2, 3, 4, 5, 6, 7]


# ------------------------------------------------------ read-only wrapping
def test_plain_dict_catalogs_wrap_read_only():
    ref = ref_star(seed=51)
    plain = port_tables(ref.snapshot())
    q = port_query(ref_query(models(seed=10)[0], group=False))
    with pytest.warns(DeprecationWarning, match="plain mapping"):
        cq = compile_query(plain, q)
    with pytest.warns(DeprecationWarning, match="plain mapping"):
        rt = compile_serving(plain, q, buckets=(8,))
    assert isinstance(cq.catalog, Catalog) and cq.catalog.read_only
    with pytest.raises(CatalogReadOnlyError):
        cq.catalog.append("d1", d1_rows(np.random.default_rng(0), 1,
                                        start=24))
    # Read-only catalogs never change version: refresh is a clean no-op.
    assert cq.refresh() == "refresh=no-op(versions unchanged)"
    assert rt.refresh() == "refresh=no-op(versions unchanged)"
    assert_same(cq.run(), compile_query(Catalog.wrap(plain), q).run())


def test_catalog_versions_and_deltas():
    both = Both(ref_star(seed=52))
    cat = both.port
    assert cat.versions(("d1", "d2")) == (("d1", 0), ("d2", 0))
    rng = np.random.default_rng(53)
    both.append("d1", d1_rows(rng, 2, start=24))
    both.append("d1", d1_rows(rng, 2, start=26))
    assert cat.version("d1") == 2
    assert len(cat.deltas_since("d1", 0)) == 2
    assert len(cat.deltas_since("d1", 1)) == 1
    with pytest.raises(ValueError, match="forward"):
        cat.deltas_since("d1", 5)
    assert cat.deltas_since("d1", 0) == tuple(
        type(d)(**vars(w)) for d, w in zip(cat.deltas_since("d1", 0),
                                           both.ref.deltas_since("d1", 0)))
    d = cat.deltas_since("d1", 0)[0]
    assert (d.kind, d.lo, d.hi) == ("append", 24, 26)
    assert cat.stale_tables({"d1": 0, "d2": 0}) == ("d1",)
    assert repr(cat) == repr(both.ref)


def test_zero_row_mutations_are_version_noops():
    both = Both(ref_star(seed=61))
    cat = both.port
    q = port_query(ref_query(models(seed=12)[0], group=False))
    rt = compile_serving(cat, q, buckets=(8,))
    cq = compile_query(cat, q)
    empty = {c: np.empty(0) for c in cat["d1"].columns}
    assert both.append("d1", empty) == 0 and cat.version("d1") == 0
    assert both.update_column("d1", "a", [], []) == 0
    assert "no-op" in rt.refresh() and "no-op" in cq.refresh()
    rng = np.random.default_rng(62)
    both.append("d1", d1_rows(rng, 2, start=24))
    assert "delta" in rt.refresh() and "delta" in cq.refresh()
    reqs = {"fk1": np.array([49, 51], np.int32),
            "fk2": np.array([0, 1], np.int32)}
    assert_same(rt.serve(reqs),
                compile_serving(cat, q, buckets=(8,)).serve(reqs))


def test_delta_log_is_bounded_and_staleness_rebuilds():
    both = Both(ref_star(seed=63))
    cat = both.port
    cat.MAX_DELTA_LOG = 4
    rq = ref_query(models(seed=13)[0], group=False)
    q = port_query(rq)
    rt = compile_serving(cat, q, buckets=(8,))
    cq = compile_query(cat, q)
    rng = np.random.default_rng(64)
    for i in range(6):                       # > MAX_DELTA_LOG appends
        cat.append("d1", d1_rows(rng, 1, start=24 + i))
    assert len(cat.deltas_since("d1", cat.version("d1") - 1)) == 1
    assert len(cat._deltas["d1"]) == 4       # bounded
    with pytest.raises(ValueError, match="compacted"):
        cat.deltas_since("d1", 0)
    assert rt.refresh() == (
        "refresh=rebuild(history-compacted: runtime staler than the delta "
        "log; replanned, jit cache reset)")
    assert cq.refresh() == (
        "refresh=recompile(history-compacted: plan staler than the delta "
        "log)")
    reqs = {"fk1": np.array([49, 59], np.int32),
            "fk2": np.array([0, 1], np.int32)}
    assert_same(rt.serve(reqs),
                compile_serving(cat, q, buckets=(8,)).serve(reqs))
    assert_same(cq.run(), compile_query(cat, q).run())


def test_bulk_update_logs_span_not_id_tuple():
    both = Both(ref_star(seed=65))
    both.ref.UPDATE_ROWS_MAX = both.port.UPDATE_ROWS_MAX = 4
    rq = ref_query(models(seed=14)[0], group=False)
    q = port_query(rq)
    want = ref_compile(both.ref, rq, backend="fused")
    got = compile_query(both.port, q, backend="fused")
    ids = np.arange(2, 10)                   # 8 > UPDATE_ROWS_MAX
    both.update_column("d1", "a", ids, np.linspace(-1, 1, 8))
    d = both.port.deltas_since("d1", 0)[0]
    assert d.rows == () and (d.lo, d.hi) == (2, 10)
    assert got.refresh() == want.refresh()
    check_plan(got, want, compile_query(both.port, q, backend="fused"), rq)


def test_duplicate_pk_append_rejected_before_commit():
    both = Both(ref_star(seed=56))
    cat = both.port
    q = port_query(ref_query(models(seed=15)[0], group=False))
    rt = compile_serving(cat, q, buckets=(8,))   # teaches the PK columns
    v0 = cat.version("d1")
    rng = np.random.default_rng(57)
    dup = d1_rows(rng, 2, start=24)
    dup["pk"] = np.array([0, 49])                # 0 already exists
    with pytest.raises(ValueError, match="already exist in unique key"):
        cat.append("d1", dup)
    assert cat.version("d1") == v0               # transactional: no commit
    assert "no-op" in rt.refresh()               # nothing poisoned
    dup_block = d1_rows(rng, 2, start=24)
    dup_block["pk"] = np.array([49, 49])         # dup within the block
    with pytest.raises(ValueError, match="within the appended block"):
        cat.append("d1", dup_block)
    cat.delete_rows("d1", [3])                   # pk 6: still reserved
    tomb = d1_rows(rng, 1, start=24)
    tomb["pk"] = np.array([6])
    with pytest.raises(ValueError, match="deleted keys stay reserved"):
        cat.append("d1", tomb)
    cat.append("d1", d1_rows(rng, 2, start=24))  # a clean append works
    assert "delta" in rt.refresh()


def test_refresh_decisions_accumulate_on_explain():
    both = Both(ref_star(seed=54))
    q = port_query(ref_query(models(seed=11)[0], group=False))
    cq = compile_query(both.port, q)
    base = cq.plan.reason
    assert "no-op" in cq.refresh()           # nothing pending
    rng = np.random.default_rng(55)
    both.port.append("d1", d1_rows(rng, 1, start=24))
    cq.refresh()
    reasons = cq.plan.reason
    assert "refresh=no-op" in reasons and "refresh=delta" in reasons
    rep = cq.explain()
    assert rep.plan_reason == base and len(rep.trail) == 2
    assert str(rep) == reasons


def test_refresh_trail_on_explain_is_bounded():
    both = Both(ref_star(seed=58, slack=96))   # 40 appends stay in capacity
    q = port_query(ref_query(models(seed=16)[0], group=False))
    cq = compile_query(both.port, q)
    rt = compile_serving(both.port, q, buckets=(8,))
    base_cq, base_rt = len(cq.plan.reason), len(rt.plan.reason)
    rng = np.random.default_rng(59)
    for i in range(40):
        both.port.append("d1", {"pk": [101 + 2 * i], "a": rng.normal(size=1),
                                "b": rng.normal(size=1)})
        cq.refresh()
        rt.refresh()
    assert len(cq.plan.reason) < base_cq + 8 * 80
    assert len(rt.plan.reason) < base_rt + 8 * 80
    assert len(cq.explain().trail) == len(rt.explain().trail) == 8
    assert "refresh=delta" in cq.plan.reason



# ------------------------------------------------ group overflow, codes
def test_group_overflow_recompiles():
    """Appended group-key values past the compiled ``num_groups`` take the
    recompile route, named as the reference names it."""
    both = Both(ref_star(seed=3))
    rq = ref_query(models(seed=1)[0], group=True)
    rq = RQ.PredictiveQuery(**{**vars(rq), "group_keys": (
        RQ.GroupKey("d2", "g", 8),), "num_groups": "auto"})
    q = port_query(rq)
    want, got = ref_compile(both.ref, rq), compile_query(both.port, q)
    assert got.query.num_groups == want.query.num_groups
    rows = d2_rows(np.random.default_rng(4), 4, start=10)
    rows["g"] = np.array([4, 5, 6, 7])
    both.append("d2", rows)
    assert got.refresh() == want.refresh() == (
        "refresh=recompile(group-overflow: live codes exceed the compiled "
        "num_groups)")
    check_plan(got, want, compile_query(both.port, q), rq)


def _groupby_codes_host(codes, num_groups):
    """The port's previous, host-side group-id resolution (numpy), kept as
    the reference the device version must equal."""
    concrete = codes.cpu().numpy()
    u = np.unique(concrete)
    n_live = int(u.size) - int(u.size > 0 and u[-1] == PAD_GROUP)
    if n_live > num_groups:
        raise ValueError("group-by overflow")
    u = u[:num_groups]
    uniq = np.full((num_groups,), PAD_GROUP, dtype=concrete.dtype)
    uniq[:u.size] = u
    gid = np.searchsorted(uniq, concrete).astype(np.int32)
    gid = np.where(concrete != PAD_GROUP, np.minimum(gid, num_groups),
                   num_groups).astype(np.int32)
    return uniq, gid


@pytest.mark.parametrize("seed", range(6))
def test_groupby_codes_on_device_match_host(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 300))
    num_groups = int(rng.integers(1, 40))
    codes = rng.integers(0, 3 * num_groups, n).astype(np.int32)
    codes[rng.random(n) < 0.3] = PAD_GROUP
    codes_t = torch.from_numpy(codes)
    try:
        want = _groupby_codes_host(codes_t, num_groups)
    except ValueError:
        with pytest.raises(ValueError, match="overflow"):
            groupby_codes(codes_t, num_groups)
        return
    uniq, gid = groupby_codes(codes_t, num_groups)
    assert uniq.dtype == torch.int32 and gid.dtype == torch.int32
    assert_same(uniq, want[0])
    assert_same(gid, want[1])
