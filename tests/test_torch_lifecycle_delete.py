"""Deletion and compaction in the port's data lifecycle against the JAX
reference, case by case after the tombstone cases of
``tests/test_outofcore.py``; the carried tombstones and versions of
``repro_torch.interop``; the partials' fixed row blocks, which make a
delta prefuse equal the cold one; and the rule that a delta refresh moves
no fact-sized tensor to the host.

As in ``tests/test_torch_lifecycle.py``: the port's refreshed plan or
runtime equals its cold compile bit for bit, and the reference's refreshed
one with the decision line exact, rows, groups, counts and tree-head sums
exact, other aggregates at rtol 1e-5 and linear-head predictions at rtol
1e-6.  The reference's serving-after-delete case refreshes through a
``Session``: here the runtime's own ``refresh()`` does, and
``tests/test_torch_session.py`` has the case through a ``Session``.  The
streaming cases of ``tests/test_outofcore.py`` are in
``tests/test_torch_streaming.py`` and ``tests/test_torch_streaming_b.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.fusion import pipeline as port_pipeline
from repro_torch.core.laq import ChangedSpans, changed_spans
from repro_torch.core.query import compile_query, compile_serving
from torch_parity import (Both, assert_partials_same, assert_preds_equal,
                          assert_same, check_plan, check_runtime, d1_rows,
                          port_catalog, port_query, ref_compile, ref_query,
                          ref_star)
from torch_parity import ref_models as models
import repro.core.query as RQ


# --------------------------------------------- deletion as a validity fold
def test_changed_spans_reports_deletes_distinct_from_updates():
    both = Both(ref_star(seed=0, n_fact=640))
    cat = both.port
    v0 = cat.version("fact")
    both.update_column("fact", "val", [3, 5], [1.0, 2.0])
    both.delete_rows("fact", [5, 9])
    cs = changed_spans(cat.deltas_since("fact", v0))
    assert isinstance(cs, ChangedSpans)
    assert cs.span is None and not cs.grew
    assert cs.dirty == (3, 5) and cs.deleted == (5, 9)
    big = both.delete_rows("fact", np.arange(100, 400))
    cs2 = changed_spans(cat.deltas_since("fact", big - 1))
    assert set(cs2.deleted) == set(range(100, 400))
    assert tuple(cs2) == tuple(changed_spans(
        both.ref.deltas_since("fact", big - 1)))


def test_delete_rows_semantics():
    both = Both(ref_star(seed=0, n_fact=640))
    cat = both.port
    t0 = cat["fact"]
    v = both.delete_rows("fact", [0, 0, 5])
    t = cat["fact"]
    assert t.num_deleted == 2 and t.num_live == int(t.nvalid) - 2
    assert not bool(t.valid_mask()[0]) and bool(t.valid_mask()[1])
    assert_same(t.valid_mask(), np.asarray(both.ref["fact"].valid_mask()))
    # placement/shapes/keys untouched: a pure validity fold
    assert t.capacity == t0.capacity and int(t.nvalid) == int(t0.nvalid)
    assert_same(t.key("fk1"), t0.key("fk1"))
    assert both.delete_rows("fact", [5]) == v       # re-delete: no-op
    assert cat.tombstone_fraction("fact") == 2 / 640
    for bad in ([-1], [640]):
        with pytest.raises(ValueError):
            cat.delete_rows("fact", bad)
    assert not both.compact("fact")                 # below threshold: no-op
    np.testing.assert_array_equal(t.to_numpy_valid(),
                                  both.ref["fact"].to_numpy_valid())


@pytest.mark.parametrize("backend", ["fused", "nonfused"])
@pytest.mark.parametrize("agg_backend", ["segment", "matmul"])
def test_refresh_after_delete_equals_cold_rebuild(backend, agg_backend):
    both = Both(ref_star(seed=21, n_fact=256))
    rq = ref_query(models(seed=1)[0], group=True, extra_aggs=True)
    q = port_query(rq)
    kw = dict(backend=backend, agg_backend=agg_backend)
    want, got = ref_compile(both.ref, rq, **kw), compile_query(both.port, q,
                                                               **kw)
    got.run()
    both.delete_rows("fact", [0, 17, 130, 255])
    both.delete_rows("d1", [3, 8])
    both.delete_rows("d2", [6])
    assert got.refresh() == want.refresh() == (
        "refresh=delta(d1+1,d2+1,fact+1; shapes kept, jit cache reused)")
    check_plan(got, want, compile_query(both.port, q, **kw), rq,
               ids=np.arange(0, 256, 7, dtype=np.int32))


@pytest.mark.parametrize("backend", ["fused", "nonfused"])
def test_serving_refresh_after_delete_equals_cold(backend):
    both = Both(ref_star(seed=13))
    rq = ref_query(models(seed=1)[1], group=True)
    q = port_query(rq)
    rt_want = RQ.compile_serving(both.ref, rq, backend=backend,
                                 buckets=(8, 32))
    rt = compile_serving(both.port, q, backend=backend, buckets=(8, 32))
    rng = np.random.default_rng(2)
    batch = {"fk1": rng.integers(0, 48, 20).astype(np.int32),
             "fk2": rng.integers(0, 10, 20).astype(np.int32)}
    rt.serve(batch)
    n0 = rt.num_compiles
    both.delete_rows("d1", [2, 5, 11])
    both.delete_rows("d2", [0, 7])
    assert rt.refresh() == rt_want.refresh()
    assert rt.num_compiles == n0
    check_runtime(rt, rt_want, compile_serving(both.port, q, backend=backend,
                                               buckets=(8, 32)), rq, batch)


def test_compact_recompiles_with_named_reason():
    both = Both(ref_star(seed=9, n_fact=640))
    rq = ref_query(models(seed=1)[0], group=True)
    q = port_query(rq)
    want, got = ref_compile(both.ref, rq), compile_query(both.port, q)
    rt_want = RQ.compile_serving(both.ref, rq, buckets=(8,))
    rt = compile_serving(both.port, q, buckets=(8,))
    both.delete_rows("fact", np.arange(0, 400, 2))
    both.delete_rows("d1", np.arange(0, 24, 2))
    assert both.compact("fact") and both.compact("d1", threshold=0.4)
    assert both.port["d1"].deleted is None
    np.testing.assert_array_equal(both.port["d1"].to_numpy_valid(),
                                  both.ref["d1"].to_numpy_valid())
    assert got.refresh() == want.refresh() == (
        "refresh=recompile(compaction:d1,fact rewrote row ids)")
    assert rt.refresh() == rt_want.refresh() == (
        "refresh=rebuild(compaction:d1 rewrote row ids; replanned, jit "
        "cache reset)")
    check_plan(got, want, compile_query(both.port, q), rq)
    reqs = {"fk1": np.array([1, 2, 8, 30], np.int32),
            "fk2": np.array([0, 1, 2, 3], np.int32)}
    check_runtime(rt, rt_want, compile_serving(both.port, q, buckets=(8,)),
                  rq, reqs)


# --------------------------------------------------------- carried state
def test_interop_carries_tombstones_and_versions():
    ref = ref_star(seed=70)
    rng = np.random.default_rng(71)
    ref.append("d1", d1_rows(rng, 2, start=24))
    ref.delete_rows("d1", [1, 25])
    ref.delete_rows("fact", [3])
    port = port_catalog(ref)
    assert port.versions() == ref.versions()
    for name in ref:
        assert_same(port[name].valid_mask(),
                    np.asarray(ref[name].valid_mask()))
        assert port[name].num_deleted == ref[name].num_deleted
    # No history before the carried versions: an older artifact rebuilds.
    with pytest.raises(ValueError, match="compacted"):
        port.deltas_since("d1", 0)
    assert port.deltas_since("d1", 2) == ()
    rq = ref_query(models(seed=5)[1], group=True)
    check_plan(compile_query(port, port_query(rq)), ref_compile(ref, rq),
               compile_query(port, port_query(rq)), rq,
               ids=np.arange(64, dtype=np.int32))


# ------------------------------------------------ partials' row blocks
@pytest.mark.parametrize("tree", [False, True])
def test_extend_prefused_equals_cold_across_blocks(monkeypatch, tree):
    """``extend_prefused`` ≡ a cold ``prefuse_dims`` bit for bit, with row
    blocks small enough that the changed rows span several blocks and the
    last block is partial."""
    monkeypatch.setattr(port_pipeline, "PREFUSE_ROW_BLOCK", 4)
    both = Both(ref_star(seed=80, n_d1=13, slack=6))
    rq = ref_query(models(seed=81)[int(tree)], group=True)
    q = port_query(rq)
    plan = compile_query(both.port, q, backend="fused")
    rt = compile_serving(both.port, q, backend="fused", buckets=(8,))
    rng = np.random.default_rng(82)
    both.append("d1", d1_rows(rng, 5, start=13))
    both.update_column("d1", "b", [0, 6, 7, 12], [1.0, -2.0, 0.5, 3.0])
    both.update_column("d2", "c", [9], [4.0])
    assert "delta" in plan.refresh() and "delta" in rt.refresh()
    cold = compile_query(both.port, q, backend="fused")
    assert_partials_same(plan.prefused, cold.prefused)
    for arm, part in zip(rt._arms, cold.prefused.partials):
        assert_same(arm.table, part)
    want = RQ.compile_query(both.ref, rq, backend="fused", rewrite="off")
    for got_p, want_p in zip(plan.prefused.partials,
                             want.prefused.partials):
        assert_preds_equal(got_p, want_p, exact=tree)


# ------------------------------------------- no fact-sized host transfers
def test_delta_refresh_moves_no_fact_sized_tensor_to_host(monkeypatch):
    """One delta ``refresh()`` after appends to a dimension and to the fact
    reads no tensor of the fact's size back to the host: every fact-sized
    step is a tensor operation on the tables' device."""
    n_fact = 4096
    both = Both(ref_star(seed=90, n_fact=n_fact, slack=64))
    q = port_query(ref_query(models(seed=91)[0], group=True))
    plan = compile_query(both.port, q, backend="fused")
    rt = compile_serving(both.port, q, backend="fused", buckets=(8,))
    rng = np.random.default_rng(92)
    both.append("d1", d1_rows(rng, 3, start=24))
    both.append("fact", {"fk1": [1, 49, 3], "fk2": [10, 12, 0],
                         "val": [0.5, -0.5, 1.5]})
    both.delete_rows("fact", [7, 8])
    big = []

    def watch(name):
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, **kw):
            if self.numel() >= n_fact:
                big.append((name, tuple(self.shape)))
            return orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, wrapped)

    for name in ("cpu", "numpy", "tolist", "__array__"):
        watch(name)
    assert "delta" in plan.refresh()
    assert "delta" in rt.refresh()
    monkeypatch.undo()
    assert big == [], f"fact-sized tensors went to the host: {big}"
    assert_same(plan.run(), compile_query(both.port, q,
                                          backend="fused").run())
