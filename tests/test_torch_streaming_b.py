"""Port parity: streaming under mutation, after ``tests/test_outofcore.py``'s
append/delete interleavings, its property sweep and its at-scale case
(the other streaming cases are in ``tests/test_torch_streaming.py``).

Each case mutates a reference catalog and its port copy in step.  After
every mutation batch the port's streamed plan, refreshed in place, equals
the port's in-core plan pinned to fused/gather/segment bit for bit and the
float64 numpy oracle (rtol 1e-5, rows aligned by the ``groups`` column);
after the last batch it also matches the reference's streamed ``run()``
(rows, groups and counts exact, float aggregates rtol 1e-5).

The reference's hypothesis property becomes a fixed list of
``(seed, chunk, ops)`` cases (no ``@given``).  It includes seed 407, where
the live ``d2`` rows hold no ``g == 0``: ``run()`` then puts groups 1, 2, 3
in slots 0, 1, 2, and an oracle indexed by raw ``g`` (as the reference's
``_oracle`` is) is off by one slot while the engine is right.
"""
import numpy as np
import pytest

import repro.core.query as RQ
from repro_torch.core.query import compile_query
from torch_parity import STREAM_EXTRA as EXTRA
from torch_parity import STREAM_KEYS as KEYS
from torch_parity import STREAM_PINNED as PINNED
from torch_parity import assert_bitwise, assert_matches_oracle
from torch_parity import assert_run_like_ref, port_catalog, port_query
from torch_parity import stream_model as ref_model
from torch_parity import stream_oracle as oracle
from torch_parity import stream_query as ref_q
from torch_parity import stream_star as star


def _equivalence_case(seed: int, chunk: int, ops: list):
    """One append/delete interleaving (the reference's
    ``_equivalence_case``, mutating both packages in step)."""
    rng = np.random.default_rng(seed)
    both = star(seed)
    model = ref_model()
    rq = ref_q(model)
    q = port_query(rq)
    streamed = compile_query(both.port, q, stream_chunk_rows=chunk)
    for kind, arg in ops:
        if kind == "append":
            both.append("fact", {"fk1": rng.integers(0, 80, arg),
                                 "fk2": rng.integers(0, 18, arg),
                                 "val": rng.normal(size=arg)})
        elif kind == "delete_fact":
            ids = rng.choice(int(both.port["fact"].nvalid), size=arg,
                             replace=False)
            both.delete_rows("fact", ids)
        else:
            ids = rng.choice(int(both.port[kind].nvalid),
                             size=min(arg, 3), replace=False)
            both.delete_rows(kind, ids)
        streamed.refresh()
        got = streamed.run()
        incore = compile_query(both.port, q, **PINNED).run()
        assert_bitwise(got, incore, KEYS)
        assert_matches_oracle(got, oracle(both.port, np.asarray(model.L)))
    want = RQ.compile_query(both.ref, rq, stream_chunk_rows=chunk).run()
    assert_run_like_ref(got, want, False)


@pytest.mark.parametrize("seed,chunk,ops", [
    (0, 1, [("delete_fact", 5), ("append", 4)]),
    (1, 93, [("append", 6), ("delete_fact", 40), ("d1", 2)]),
    (2, 640, [("d2", 1), ("delete_fact", 10), ("append", 10),
              ("delete_fact", 30)]),
    (3, 5000, [("append", 16), ("d1", 3), ("d2", 2),
               ("delete_fact", 100)]),
])
def test_append_delete_interleavings(seed, chunk, ops):
    _equivalence_case(seed, chunk, ops)


@pytest.mark.parametrize("seed,chunk,ops", [
    (407, 10000, [("append", 1)]),
    (65536, 1, [("d2", 2), ("append", 8)]),
    (1234, 700, [("delete_fact", 60), ("d1", 3), ("append", 3),
                 ("d2", 1)]),
    (31337, 10000, [("d2", 2), ("d2", 2)]),
    (9, 333, [("append", 5), ("delete_fact", 1)]),
    (2718, 64, [("d1", 1), ("delete_fact", 17), ("d2", 1),
                ("append", 7)]),
])
def test_streaming_equivalence_property(seed, chunk, ops):
    """Chunk sizes (1, non-divisors, past the fact rows), tombstone sets
    and append/delete interleavings never break the three-way
    equivalence."""
    _equivalence_case(seed, chunk, ops)


def test_seed_407_groups_column_aligns_the_oracle():
    """The diagnosis of the reference's unsteady property case: at seed
    407 the ``groups`` column is ``[1, 2, 3, PAD_KEY]``, so slot 0 holds
    group 1, not group 0."""
    both = star(407)
    model = ref_model()
    got = compile_query(both.port, port_query(ref_q(model)),
                        stream_chunk_rows=10000).run()
    codes = got["groups"].tolist()
    assert codes[:3] == [1, 2, 3] and codes[3] == 2**31 - 1
    want = oracle(both.port, np.asarray(model.L))
    assert want["n"][0] == 0          # no live row joins a g == 0 row
    np.testing.assert_array_equal(got["n"].numpy(),
                                  np.append(want["n"][1:], 0.0))
    assert_matches_oracle(got, want)


def test_stream_at_scale_under_budget():
    """A fact ~40x the memory budget streams in budget-sized chunks and
    still matches the pinned in-core program bit for bit."""
    both = star(0, n_fact=200_000, slack=64)
    rq = ref_q(ref_model(), extra_aggs=True)
    q = port_query(rq)
    streamed = compile_query(both.port, q, memory_budget_bytes=256 * 1024)
    assert streamed._stream is not None
    assert streamed._stream.chunk_bytes() <= 256 * 1024
    incore = compile_query(port_catalog(both.ref), q, **PINNED)
    assert_bitwise(streamed.run(), incore.run(), EXTRA)
    want = RQ.compile_query(both.ref, rq, memory_budget_bytes=256 * 1024)
    assert streamed._stream.describe() == want._stream.describe()
