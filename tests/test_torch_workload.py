"""The port's workload generator, oracle and checker against the JAX
reference, case for case with ``tests/test_fuzz_workload.py``.

``generate_case(seed)`` must give the reference's tables and query for the
same seed, and ``np_oracle`` / ``np_serving_oracle`` (float64 numpy, copied
into the port) the reference's answers, exactly.  ``check_case`` and
``run_fuzz`` run on the CPU here (``device="cpu"``); each case's results
equal the oracle bit for bit (integer-valued data).
"""
import numpy as np
import pytest

from repro.core.query.workload import generate_case as ref_generate_case
from repro.core.query.workload import np_oracle as ref_np_oracle
from repro.core.query.workload import \
    np_serving_oracle as ref_np_serving_oracle
from repro_torch.core.query import (FuzzCase, FuzzReport, generate_case,
                                    np_oracle, query_key, run_fuzz)
from repro_torch.core.query.workload import check_case, np_serving_oracle
from torch_parity import assert_case_equal, to_np


def assert_oracle_equal(got, want):
    assert got["rows"] == want["rows"]
    for part in ("scalars", "groups"):
        g, w = got[part], want[part]
        assert (g is None) == (w is None)
        if w is None:
            continue
        assert set(g) == set(w)
        for k in w:
            if part == "groups":
                assert set(g[k]) == set(w[k])
                for name in w[k]:
                    np.testing.assert_array_equal(g[k][name], w[k][name])
            elif w[k] is None:
                assert g[k] is None
            else:
                np.testing.assert_array_equal(g[k], w[k])


def test_generator_is_deterministic():
    a = generate_case(123, device="cpu")
    b = generate_case(123, device="cpu")
    assert isinstance(a, FuzzCase)
    assert query_key(a.query) == query_key(b.query)
    assert set(a.tables) == set(b.tables)
    for n in a.tables:
        np.testing.assert_array_equal(to_np(a.tables[n].matrix),
                                      to_np(b.tables[n].matrix))
    # and distinct seeds actually vary the workload
    c = generate_case(124, device="cpu")
    assert (query_key(c.query) != query_key(a.query)
            or set(c.tables) != set(a.tables))


def test_generated_schemas_cover_chains():
    depths, models, grouped, preds = set(), set(), set(), set()
    for seed in range(40):
        q = generate_case(seed, device="cpu").query
        depths.add(max((len(a.links) for a in q.arms), default=0))
        models.add(type(q.model).__name__)
        grouped.add(bool(q.group_keys))
        preds.add(bool(q.fact_preds)
                  or any(a.preds or any(lk.preds for lk in a.links)
                         for a in q.arms))
    assert any(d >= 2 for d in depths)      # depth ≥ 2 chains appear
    assert len(models) >= 2                 # with and without a model
    assert grouped == {True, False}
    assert True in preds


def test_oracle_counts_star_rows():
    case = generate_case(11, device="cpu")
    want = np_oracle(case.tables, case.query)
    assert 0 <= want["rows"] <= int(case.tables[case.query.fact].nvalid)


@pytest.mark.parametrize("seed", range(0, 500, 25))
def test_generator_and_oracles_match_reference(seed):
    case, ref = generate_case(seed, device="cpu"), ref_generate_case(seed)
    assert_case_equal(case, ref)
    assert_oracle_equal(np_oracle(case.tables, case.query),
                        ref_np_oracle(ref.tables, ref.query))
    if case.query.model is not None:
        np.testing.assert_array_equal(
            np_serving_oracle(case.tables, case.query),
            ref_np_serving_oracle(ref.tables, ref.query))


@pytest.mark.parametrize("seed", [0, 7, 19, 42])
def test_fuzz_case_full_matrix(seed):
    assert check_case(seed, full=True, device="cpu") == []


def test_fuzz_small_corpus():
    rep = run_fuzz(12, seed=2, device="cpu")
    assert isinstance(rep, FuzzReport)
    assert rep.ok, rep.failures
    assert rep.cases == 12 and len(rep.seeds) == 12
    assert rep.summary() == "fuzz: 12 cases, 0 mismatches"
