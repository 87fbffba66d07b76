"""Port parity: out-of-core streaming of the fact axis
(``repro_torch.core.query.streaming``), case by case after the streaming
cases of ``tests/test_outofcore.py`` (its chunk sweep through the pooled
dimension-side invariant; the interleavings, the fixed property cases and
the at-scale case are in ``tests/test_torch_streaming_b.py``).

On the CPU the contract is the reference's: a streamed ``run()`` equals
the in-core ``run()`` pinned to fused/gather/segment bit for bit for every
chunk size (grouped aggregates and ungrouped count/min/max; ungrouped
sum/mean at rtol 1e-5), because ``index_add_`` folds rows in order.  Each
case is also held against the reference's streamed ``run()`` on the same
seed (rows, groups and counts exact, float aggregates rtol 1e-5 with atol
1e-5 of the largest magnitude) and, where the reference checks one,
against a float64 numpy oracle aligned by the ``groups`` column.
"""
import numpy as np
import pytest

import repro.core.query as RQ
from repro.core.query.multiquery import stack_key as ref_stack_key
from repro_torch.core.query import (Session, compile_query, plan_chunk_rows,
                                    plan_streaming)
from repro_torch.core.query.multiquery import stack_key
from repro_torch.core.query.streaming import assert_pool_dimension_side
from torch_parity import STREAM_EXTRA as EXTRA
from torch_parity import STREAM_PINNED as PINNED
from torch_parity import assert_bitwise, assert_matches_oracle
from torch_parity import assert_run_like_ref, port_catalog, port_query
from torch_parity import to_np
from torch_parity import stream_model as ref_model
from torch_parity import stream_oracle as oracle
from torch_parity import stream_query as ref_q
from torch_parity import stream_star as star


def ref_streamed(ref_cat, rq, **kw):
    """The reference's streamed ``run()`` (its default rewrite="on")."""
    return RQ.compile_query(ref_cat, rq, **kw).run()



# ------------------------------------------------- streamed ≡ in-core ≡ ref
@pytest.mark.parametrize("chunk", [1, 7, 64, 100, 999, 5000])
def test_grouped_stream_bitexact_chunk_sweep(chunk):
    both = star(0)
    rq = ref_q(ref_model(), extra_aggs=True)
    q = port_query(rq)
    streamed = compile_query(both.port, q, stream_chunk_rows=chunk)
    incore = compile_query(port_catalog(both.ref), q, **PINNED)
    assert streamed._stream is not None
    got = streamed.run()
    assert_bitwise(got, incore.run(), EXTRA)
    assert_run_like_ref(got, ref_streamed(both.ref, rq,
                                          stream_chunk_rows=chunk), False)
    assert streamed.explain().as_dict()["extras"]["stream"] == (
        RQ.compile_query(both.ref, rq, stream_chunk_rows=chunk)
        ._stream.describe())


def test_stream_kernel_route_bitexact():
    """``serve_backend="kernel"`` runs each chunk through
    ``predict_fused_kernel`` (the kernel's plain version on the CPU): the
    same bits as the torch route and the in-core run."""
    both = star(0)
    q = port_query(ref_q(ref_model(), extra_aggs=True))
    streamed = compile_query(both.port, q, stream_chunk_rows=100,
                             serve_backend="kernel")
    assert streamed._stream._use_kernel
    incore = compile_query(port_catalog(both.ref), q, **PINNED)
    assert_bitwise(streamed.run(), incore.run(), EXTRA)


@pytest.mark.parametrize("chunk", [1, 100, 5000])
def test_ungrouped_stream(chunk):
    both = star(3)
    rq = ref_q(ref_model(), group=False, extra_aggs=True)
    q = port_query(rq)
    streamed = compile_query(both.port, q, stream_chunk_rows=chunk).run()
    incore = compile_query(port_catalog(both.ref), q, **PINNED).run()
    assert_bitwise(streamed, incore, ("n", "vmin", "vmax"))
    for k in ("pred", "pmean", "v", "v2"):
        np.testing.assert_allclose(to_np(streamed[k]), to_np(incore[k]),
                                   rtol=1e-5)
    assert_run_like_ref(streamed, ref_streamed(both.ref, rq,
                                               stream_chunk_rows=chunk),
                        False)


@pytest.mark.parametrize("group", [True, False])
def test_stream_matches_numpy_oracle(group):
    both = star(5)
    model = ref_model()
    both.delete_rows("fact", [0, 3, 100, 639])
    both.delete_rows("d1", [2, 9])
    rq = ref_q(model, group=group)
    got = compile_query(both.port, port_query(rq), stream_chunk_rows=97).run()
    assert_matches_oracle(got, oracle(both.port, np.asarray(model.L),
                                      group=group), group=group)
    assert_run_like_ref(got, ref_streamed(both.ref, rq,
                                          stream_chunk_rows=97), False)


def test_stream_refresh_zero_retrace_and_bitexact():
    """Append + delete within capacity: the executor keeps its buffers
    (``traces`` unchanged, the same host storage) and the refreshed stream
    equals a cold compile bit for bit."""
    rng = np.random.default_rng(11)
    both = star(7)
    rq = ref_q(ref_model(), extra_aggs=True)
    q = port_query(rq)
    streamed = compile_query(both.port, q, stream_chunk_rows=128)
    ref_plan = RQ.compile_query(both.ref, rq, stream_chunk_rows=128)
    streamed.run()
    traces0 = streamed._stream.traces
    assert traces0 >= 1
    host0 = {k: v.data_ptr() for k, v in streamed._stream._host.items()}
    both.append("fact", {"fk1": rng.integers(0, 80, 8),
                         "fk2": rng.integers(0, 18, 8),
                         "val": rng.normal(size=8)})
    both.delete_rows("fact", [5, 77, 400, 641])
    both.delete_rows("d1", [1, 4])
    note = streamed.refresh()
    assert "delta" in note and note == ref_plan.refresh()
    cold = compile_query(port_catalog(both.ref), q, stream_chunk_rows=128)
    got = streamed.run()
    assert_bitwise(got, cold.run(), EXTRA)
    assert streamed._stream.traces == traces0, "chunk buffers rebuilt"
    assert {k: v.data_ptr()
            for k, v in streamed._stream._host.items()} == host0
    assert_run_like_ref(got, ref_plan.run(), False)


def test_compact_recompiles_with_named_reason():
    both = star(9)
    rq = ref_q(ref_model())
    q = port_query(rq)
    streamed = compile_query(both.port, q, stream_chunk_rows=64)
    streamed.run()
    both.delete_rows("fact", np.arange(0, 400, 2))
    assert both.compact("fact")
    note = streamed.refresh()
    assert "compaction:fact" in note
    got = streamed.run()
    assert_bitwise(got, compile_query(port_catalog(both.ref), q,
                                      stream_chunk_rows=64).run(),
                   ("pred", "v", "n"))
    assert_run_like_ref(got, ref_streamed(both.ref, rq,
                                          stream_chunk_rows=64), False)


# ----------------------------------------------------------- planner choice
def _stream_reason(reason: str) -> str:
    return next(p for p in reason.split("; ") if p.startswith("stream="))


def test_memory_budget_drives_streaming():
    both = star(0)
    rq = ref_q(ref_model())
    q = port_query(rq)
    small = compile_query(both.port, q, memory_budget_bytes=20_000)
    assert small._stream is not None
    assert "stream=" in small.plan.reason
    big = compile_query(both.port, q, memory_budget_bytes=10**9)
    assert big._stream is None
    assert "stream=off" in big.plan.reason
    for plan, budget in ((small, 20_000), (big, 10**9)):
        want = RQ.compile_query(both.ref, rq, memory_budget_bytes=budget)
        assert (_stream_reason(plan.plan.reason)
                == _stream_reason(want.plan.reason))
        assert plan.plan.stream_chunk_rows == want.plan.stream_chunk_rows
    assert_bitwise(small.run(), compile_query(port_catalog(both.ref), q,
                                              **PINNED).run(),
                   ("pred", "v", "n"))


def test_plan_chunk_rows_unit():
    cases = [(64, 1000, 100, None), (None, 1000, 100, None),
             (None, 1000, 100, 10**9), (None, 1000, 100, 20_000),
             ("auto", 1000, 100, 20_000), ("auto", 1000, 100, 1),
             (0, 1000, 100, None), ("auto", 1000, 100, None)]
    assert plan_chunk_rows(64, 1000, 100, None) == 64
    assert plan_chunk_rows(None, 1000, 100, None) is None
    assert plan_chunk_rows(None, 1000, 100, 10**9) is None
    assert plan_chunk_rows(None, 1000, 100, 20_000) == 200
    assert plan_chunk_rows("auto", 1000, 100, 20_000) == 200
    assert 1 <= plan_chunk_rows("auto", 1000, 100, 1) <= 1000
    assert plan_chunk_rows(0, 1000, 100, None) is None
    with pytest.raises(ValueError):
        plan_chunk_rows(-1, 1000, 100, None)
    on, why = plan_streaming(64, 1000, 100, None)
    assert on == 64 and "stream=" in why
    for args in cases:
        assert plan_chunk_rows(*args) == RQ.plan_chunk_rows(*args), args
        assert plan_streaming(*args) == RQ.plan_streaming(*args), args


def test_stream_rejects_incompatible_backends():
    """The three conflicting overrides raise the reference's ValueError.
    (The reference's other case, streaming under an outer ``jax.jit``,
    has no counterpart: the port never traces.)"""
    both = star(0)
    rq = ref_q(ref_model())
    q = port_query(rq)
    for bad in (dict(backend="nonfused"), dict(join_backend="matmul"),
                dict(agg_backend="matmul")):
        with pytest.raises(ValueError, match="stream") as got:
            compile_query(both.port, q, stream_chunk_rows=64, **bad)
        with pytest.raises(ValueError) as want:
            RQ.compile_query(both.ref, rq, stream_chunk_rows=64, **bad)
        assert str(got.value) == str(want.value)


# -------------------------------------------------------- session composure
def test_session_stream_knob_and_explain():
    both = star(0)
    sess = Session(both.port, stream_chunk_rows=100)
    rq = ref_q(ref_model())
    q = port_query(rq)
    c = sess.compile(q)
    assert c._stream is not None
    report = c.explain().as_dict()
    assert report["extras"]["stream"].startswith("stream:")
    assert "stream=" in report["plan_reason"]
    assert stack_key(c) is None
    ref_sess = RQ.Session(both.ref, stream_chunk_rows=100)
    assert ref_stack_key(ref_sess.compile(rq)) is None
    base = compile_query(port_catalog(both.ref), q, **PINNED).run()
    for out in (c.run(), sess.run_all([q])[0]):
        assert_bitwise(out, base, ("pred", "v", "n"))
    # Without the knobs, the session's plan-cache keys are unchanged.
    plain = Session(both.port)
    assert plain._stream_kwargs() == {} and plain._stream_kwargs(
        serving=True) == {}
    budget = Session(both.port, memory_budget_bytes=10**9,
                     stream_chunk_rows=100)
    assert budget._stream_kwargs(serving=True) == {
        "memory_budget_bytes": 10**9}


def test_pooled_artifacts_are_dimension_side_and_shared():
    both = star(0)
    sess = Session(both.port, stream_chunk_rows=64)
    model = ref_model()
    c1 = sess.compile(port_query(ref_q(model)))
    c2 = sess.compile(port_query(ref_q(model, extra_aggs=True)))
    assert c1 is not c2 and c1._stream is not None
    shared = set(c1._pool_keys()) & set(c2._pool_keys())
    assert any(k[0] == "partial" for k in shared)
    assert any(k[0] == "join" for k in shared)
    # The invariant compile_query asserts: a copied partial breaks it.
    refs = c1._pool_refs
    assert_pool_dimension_side(sess.pool, refs, c1._state, c1.star)
    state = dict(c1._state)
    state["partials"] = tuple(p.clone() for p in state["partials"])
    with pytest.raises(AssertionError, match="pooled partial"):
        assert_pool_dimension_side(sess.pool, refs, state, c1.star)
