"""Port parity: dynamic-batch serving (``repro_torch.core.query.serving``)
vs the reference's ``compile_serving(serve_backend="jnp")``, its float64
``np_serving_oracle``, and the port's own ``predict_rows``.

Both packages read the same SSB tables (``scale=0.0005``), carried into the
port through ``repro_torch.interop``.  P1–P4 run fused and nonfused under
the port's two serve backends; on the CPU the ``"kernel"`` backend runs
each kernel's plain version behind the same wrapper calls it makes on the
card.  Requests come in ragged sizes (empty, inside each bucket, at a
bucket's edge, and above the top bucket, which is served in chunks), in
the three request forms, and mix fact rows' keys with random keys that
miss.

Tolerances:
  * exact — tree heads everywhere; fused linear heads against the port's
    own ``predict_rows`` (same partials, same add order); the fuzzer's
    integer-valued cases against ``np_serving_oracle``;
  * rtol 1e-6 (1 ulp) with atol 1e-6 of the largest magnitude
    (``torch_parity.assert_preds_equal``) — linear heads against the
    reference (torch and XLA round the prefuse and model matmuls
    differently, and a matmul's rounding depends on the batch shape) and
    against the float64 oracle on SSB's non-integer weights.
"""
import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.query as RQ
from repro.core.fusion import LinearOperator as RefLinear
from repro.core.fusion import random_tree as ref_random_tree
from repro.core.laq import Catalog
from repro.core.query.workload import generate_case, np_serving_oracle
from repro.data import QUERY_IR as REF_QUERY_IR
from repro.data import generate_star as ref_generate_star
from repro.data import predictive_query_names as ref_predictive_names
from repro_torch.core.query import (DEFAULT_BUCKETS, LATENCY_WINDOW,
                                    PredictionFilter, SentinelKeyError,
                                    compile_query, compile_serving,
                                    query_from_star, requests_from_rows)
from repro_torch.data import QUERY_IR, generate_star
from torch_parity import (assert_preds_equal, is_tree, port_model,
                          port_query, port_tables, ref_ssb_catalog, to_np)

PRED_NAMES = ref_predictive_names()
BUCKETS = (8, 32, 128)
SIZES = (0, 1, 3, 8, 9, 31, 33, 128, 300)
FORMS = ("mapping", "sequence", "stacked")


@pytest.fixture(scope="module")
def ref_cat():
    return ref_ssb_catalog()


@pytest.fixture(scope="module")
def tables(ref_cat):
    return port_tables(ref_cat)


@pytest.fixture(scope="module")
def ref_runtimes():
    """Reference runtimes, compiled once per (query, backend)."""
    return {}


def _ref_runtime(cache, ref_cat, name, backend):
    if (name, backend) not in cache:
        cache[name, backend] = RQ.compile_serving(
            ref_cat, REF_QUERY_IR[name](), backend=backend,
            serve_backend="jnp", buckets=BUCKETS)
    return cache[name, backend]


def _requests(ref_cat, q, n, rng, from_rows):
    """One request batch: fact rows' keys, or random keys over each
    dimension's key range plus 1/16 past it and a few negatives (misses)."""
    if from_rows:
        ids = rng.integers(0, int(ref_cat[q.fact].nvalid), size=n)
        return RQ.requests_from_rows(ref_cat[q.fact], q, ids)
    reqs = {}
    for arm in q.arms:
        rows = int(ref_cat[arm.table].nvalid)
        keys = rng.integers(0, rows * 17 // 16 + 1, size=n)
        keys[rng.random(n) < 0.05] = -1
        reqs[arm.fk_col] = keys.astype(np.int32)
    return reqs


def _as_form(reqs, keys, form):
    """A request mapping as one of the three forms ``serve`` takes."""
    if form == "mapping":
        return {k: torch.from_numpy(np.asarray(v)) for k, v in reqs.items()}
    cols = [np.asarray(reqs[k]) for k in keys]
    if form == "sequence":
        return cols
    return torch.from_numpy(np.stack(cols))


def _passing_rows(tables, q):
    """Fact rows on which serving and predict_rows must agree."""
    fact = tables[q.fact]
    ok = fact.valid_mask()
    for p in q.fact_preds:
        ok = ok & p.mask(fact)
    return torch.nonzero(ok).flatten()


def _expected_serve(serve, backend, name):
    return ("kernel" if serve == "kernel" and (backend == "fused"
                                               or is_tree(name))
            else "torch")


# ------------------------------------------------ serve ≡ reference serve
@pytest.mark.parametrize("serve", ["torch", "kernel"])
@pytest.mark.parametrize("backend", ["fused", "nonfused"])
@pytest.mark.parametrize("name", PRED_NAMES)
def test_serve_matches_reference(name, backend, serve, tables, ref_cat,
                                 ref_runtimes):
    q = QUERY_IR[name]()
    rt = compile_serving(tables, q, backend=backend, serve_backend=serve,
                         buckets=BUCKETS)
    want_rt = _ref_runtime(ref_runtimes, ref_cat, name, backend)
    assert rt.backend == backend
    assert rt.serve_backend == _expected_serve(serve, backend, name)
    assert rt.request_keys == want_rt.request_keys
    assert rt.out_width == want_rt.out_width
    rng = np.random.default_rng(len(name) + len(backend))
    for i, n in enumerate(SIZES):
        reqs = _requests(ref_cat, REF_QUERY_IR[name](), n, rng,
                         from_rows=i % 2 == 0)
        got = rt.serve(_as_form(reqs, rt.request_keys, FORMS[i % 3]))
        assert tuple(got.shape) == (n, rt.out_width)
        assert_preds_equal(got, want_rt.serve(reqs), exact=is_tree(name))
    assert rt.num_compiles <= len(BUCKETS)


# --------------------------------------------- serve ≡ port predict_rows
@pytest.mark.parametrize("serve", ["torch", "kernel"])
@pytest.mark.parametrize("backend", ["fused", "nonfused"])
@pytest.mark.parametrize("name", PRED_NAMES)
def test_serve_matches_predict_rows(name, backend, serve, tables):
    """On fact-predicate-passing rows serving reproduces ``predict_rows``:
    exactly for fused heads and trees; nonfused linear heads run the model
    matmul on another batch shape (1 ulp)."""
    q = QUERY_IR[name]()
    rt = compile_serving(tables, q, backend=backend, serve_backend=serve,
                         buckets=BUCKETS)
    plan = compile_query(tables, q, backend=backend, serve_backend=serve)
    ids = _passing_rows(tables, q)[:200]
    got = rt.serve(requests_from_rows(tables[q.fact], q, ids))
    want = plan.predict_rows(ids)
    assert_preds_equal(got, want,
                       exact=backend == "fused" or is_tree(name))


# ------------------------------------------- serve ≡ float64 numpy oracle
@pytest.mark.parametrize("backend", ["fused", "nonfused"])
@pytest.mark.parametrize("name", PRED_NAMES)
def test_serve_matches_numpy_oracle(name, backend, tables, ref_cat):
    """Every fact row's keys (chunked above the top bucket) against the
    reference's float64 serving oracle."""
    q = QUERY_IR[name]()
    rt = compile_serving(tables, q, backend=backend, buckets=BUCKETS)
    n = int(tables[q.fact].nvalid)
    got = rt.serve(requests_from_rows(tables[q.fact], q, np.arange(n)))
    ref_tables = {t: ref_cat[t] for t in tables}
    want = np_serving_oracle(ref_tables, REF_QUERY_IR[name]())
    assert_preds_equal(got, want.astype(np.float32), exact=is_tree(name))


# ----------------------------------------- fuzzer cases vs numpy oracle
def _chain_free_model_seeds(limit=48):
    """Seeds of the reference's ``generate_case`` whose arms are flat and
    whose query has a model head (serving needs one)."""
    qs = {s: generate_case(s).query for s in range(limit)}
    return [s for s, q in qs.items()
            if q.model is not None and not any(a.links for a in q.arms)]


@pytest.mark.parametrize("serve", ["torch", "kernel"])
@pytest.mark.parametrize("backend", ["fused", "nonfused"])
@pytest.mark.parametrize("seed", _chain_free_model_seeds())
def test_fuzz_case_serving_matches_oracle(seed, backend, serve):
    """Integer-valued random stars: every float32 sum is exact, so the
    port's serving equals the float64 oracle bit for bit."""
    case = generate_case(seed)
    ref_q = dataclasses.replace(case.query, model_preds=())
    tables = port_tables(case.tables)
    q = port_query(ref_q)
    rt = compile_serving(tables, q, backend=backend, serve_backend=serve,
                         buckets=(4, 16))
    n = int(tables[q.fact].nvalid)
    got = rt.serve(requests_from_rows(tables[q.fact], q, np.arange(n)))
    want = np_serving_oracle(case.tables, ref_q)
    np.testing.assert_array_equal(to_np(got).astype(np.float64), want)


# ------------------------------------- compile once, serve any batch size
@pytest.mark.parametrize("serve", ["torch", "kernel"])
def test_ragged_batches_stay_in_the_bucket_set(serve, tables, ref_cat):
    """Ragged and oversized batches: at most one first call per bucket,
    chunked calls timed per request, and ``latency_stats`` with the
    reference's key set after the same traffic."""
    name = "P3.tree.year"
    q = QUERY_IR[name]()
    rt = compile_serving(tables, q, serve_backend=serve, buckets=BUCKETS)
    ref_rt = RQ.compile_serving(ref_cat, REF_QUERY_IR[name](),
                                serve_backend="jnp", buckets=BUCKETS)
    rng = np.random.default_rng(0)
    sizes = [1, 3, 8, 9, 31, 32, 33, 100, 128]
    for n in sizes + sizes + [129, 300, 1000]:
        reqs = _requests(ref_cat, REF_QUERY_IR[name](), n, rng,
                         from_rows=False)
        assert_preds_equal(rt.serve(reqs), ref_rt.serve(reqs), exact=True)
        assert rt.num_compiles <= len(BUCKETS)
    assert rt.num_compiles == len(BUCKETS)
    stats, ref_stats = rt.latency_stats(), ref_rt.latency_stats()
    assert set(stats) == set(ref_stats) == set(BUCKETS) | {"chunked"}
    for key in stats:
        assert set(stats[key]) == set(ref_stats[key])
        assert stats[key]["count"] == ref_stats[key]["count"]
        assert stats[key]["p50"] <= stats[key]["p99"]
    assert stats["chunked"]["count"] == 3
    assert all(s["count"] == 5 for b, s in stats.items() if b != "chunked")
    history = rt.compile_history()
    assert len(history) == 1 and set(history[0]) == set(BUCKETS)
    assert rt.explain().as_dict().keys() == ref_rt.explain().as_dict().keys()
    assert rt.explain().kind == "serving"


@pytest.mark.parametrize("n, key", [(5, 8), (300, "chunked")])
def test_latency_sample_covers_the_whole_call(n, key, tables, monkeypatch):
    """A sample starts before the key checks and the padding: with each of
    them slowed by 10 ms, every sample reads at least 20 ms."""
    rt = compile_serving(tables, QUERY_IR["P1.linear.year"](),
                         buckets=BUCKETS)
    for method in ("_normalize", "_admit"):
        orig = getattr(rt, method)

        def slow(*args, _orig=orig):
            time.sleep(0.01)
            return _orig(*args)
        monkeypatch.setattr(rt, method, slow)
    reqs = {k: np.zeros(n, np.int32) for k in rt.request_keys}
    for _ in range(3):
        rt.serve(reqs)
    stats = rt.latency_stats()[key]
    assert stats["count"] == (2 if key == 8 else 3)
    assert stats["p50"] >= 20.0
    if key == 8:
        assert stats["compile_ms"] >= 20.0


def test_default_buckets_match_reference():
    assert DEFAULT_BUCKETS == RQ.DEFAULT_BUCKETS
    assert LATENCY_WINDOW == RQ.serving.LATENCY_WINDOW


# ---------------------------------------------------- request validation
def test_request_validation(tables):
    q = QUERY_IR["P1.linear.year"]()
    rt = compile_serving(tables, q, backend="fused", buckets=BUCKETS)
    keys = rt.request_keys
    empty = rt.serve({k: np.zeros(0, np.int32) for k in keys})
    assert tuple(empty.shape) == (0, rt.out_width)
    assert empty.dtype == torch.float32
    with pytest.raises(KeyError, match="missing fk columns"):
        rt.serve({"nope": np.zeros(4, np.int32)})
    with pytest.raises(ValueError, match="ragged"):
        rt.serve([np.zeros(4, np.int32)] * (len(keys) - 1)
                 + [np.zeros(5, np.int32)])
    with pytest.raises(ValueError, match="fk columns"):
        rt.serve([np.zeros(4, np.int32)] * (len(keys) + 1))
    bad = {k: np.zeros(4, np.int32) for k in keys}
    bad[keys[-1]] = np.array([0, 1, 2**31 - 1, 3], np.int32)
    with pytest.raises(SentinelKeyError, match="PAD_KEY"):
        rt.serve(bad)
    with pytest.raises(ValueError, match="cannot admit"):
        rt._admit(np.zeros((len(keys), BUCKETS[-1] + 1), np.int32))
    with pytest.raises(IndexError):
        requests_from_rows(tables[q.fact], q, [tables[q.fact].capacity])


def test_compile_serving_validation(tables):
    with pytest.raises(ValueError, match="model head"):
        compile_serving(tables, QUERY_IR["Q1.1"]())
    q = QUERY_IR["P3.tree.year"]()
    with pytest.raises(ValueError, match="model_preds"):
        compile_serving(tables, dataclasses.replace(
            q, model_preds=(PredictionFilter(0, "==", 1.0),)))
    with pytest.raises(ValueError, match="backend"):
        compile_serving(tables, q, backend="dense")
    with pytest.raises(ValueError, match="serve_backend"):
        compile_serving(tables, q, serve_backend="pallas")
    with pytest.raises(ValueError, match="buckets"):
        compile_serving(tables, q, buckets=(0, 8))
    with pytest.raises(ValueError, match="star arm"):
        compile_serving(tables, dataclasses.replace(q, arms=()))


# ------------------------------------------- synthetic star (setting 1)
@pytest.mark.parametrize("backend", ["fused", "nonfused"])
@pytest.mark.parametrize("kind", ["linear", "tree"])
def test_query_from_star_serving_matches_reference(kind, backend):
    """``query_from_star`` over the synthetic setting-1 star (cut to scale
    0.0005) builds the reference's catalog and query; serving it gives the
    reference's predictions."""
    k = 12
    ref_syn = ref_generate_star(1, 1, k, seed=3, scale=0.0005)
    syn = generate_star(1, 1, k, seed=3, scale=0.0005, device="cpu")
    rng = np.random.default_rng(3)
    ref_model = (RefLinear(jnp.asarray(
        rng.normal(size=(k, 8)).astype(np.float32))) if kind == "linear"
        else ref_random_tree(rng, k, 3))
    cat, q = query_from_star(syn.star, model=port_model(ref_model))
    ref_cat, ref_q = RQ.query_from_star(ref_syn.star, model=ref_model)
    assert set(cat) == set(ref_cat)
    for name in cat:
        np.testing.assert_array_equal(to_np(cat[name].matrix),
                                      to_np(ref_cat[name].matrix))
    assert port_query(ref_q).arms == q.arms
    assert [(a.value, a.op, a.name) for a in q.aggregates] == [
        (a.value, a.op, a.name) for a in ref_q.aggregates]
    assert q.num_groups == ref_q.num_groups
    rt = compile_serving(cat, q, backend=backend, serve_backend="kernel",
                         buckets=(16, 64))
    ref_rt = RQ.compile_serving(Catalog(ref_cat), ref_q, backend=backend,
                                serve_backend="jnp", buckets=(16, 64))
    ids = np.arange(int(syn.n_fact))
    got = rt.serve(requests_from_rows(syn.star.fact, q, ids))
    want = ref_rt.serve(RQ.requests_from_rows(ref_syn.star.fact, ref_q, ids))
    assert_preds_equal(got, want, exact=kind == "tree")
