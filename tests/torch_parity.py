"""Shared helpers for the port's parity tests (``tests/test_torch_*.py``).

Data crosses between the JAX package and the port only as numpy arrays,
through ``repro_torch.interop``; every port object here lives on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import torch

import repro.core.query as RQ
from repro.core.fusion import DecisionTreeGEMM as RefTree
from repro.data import QUERY_IR as REF_QUERY_IR
from repro.data import generate_ssb as ref_generate_ssb
from repro.data import ssb_catalog
from repro_torch.core.query import compile_query
from repro_torch.data import QUERY_IR
from repro_torch.interop import model_from_arrays, table_from_arrays


def to_np(x):
    """numpy view of a torch tensor or jax array (None passes through)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def port_table(ref_table):
    """The port's copy of a reference ``Table`` (same arrays, on the CPU)."""
    return table_from_arrays(
        ref_table.name, ref_table.columns, np.asarray(ref_table.matrix),
        {c: np.asarray(k) for c, k in ref_table.keys.items()},
        int(ref_table.nvalid), device="cpu")


def port_tables(ref_catalog):
    return {name: port_table(t) for name, t in ref_catalog.items()}


def port_model(ref_model):
    """The port's copy of a reference model head."""
    if hasattr(ref_model, "L"):
        bias = None if ref_model.bias is None else np.asarray(ref_model.bias)
        return model_from_arrays("linear", L=np.asarray(ref_model.L),
                                 bias=bias)
    return model_from_arrays("tree", F=np.asarray(ref_model.F),
                             v=np.asarray(ref_model.v),
                             H=np.asarray(ref_model.H),
                             h=np.asarray(ref_model.h))


# ------------------------------------------------------------ query parity
def ref_ssb_catalog():
    """The reference's SSB catalog at the parity tests' size."""
    return ssb_catalog(ref_generate_ssb(sf=1, scale=0.0005, seed=5))


def ref_plan(cache, ref_cat, name, **kw):
    """The reference's ``rewrite="off"`` plan, compiled once per option set
    (Pallas kernels in interpret mode, as its own tests run them)."""
    key = (name, tuple(sorted(kw.items())))
    if key not in cache:
        cache[key] = RQ.compile_query(ref_cat, REF_QUERY_IR[name](),
                                      rewrite="off", interpret=True, **kw)
    return cache[key]


def is_tree(name):
    return isinstance(REF_QUERY_IR[name]().model, RefTree)


def assert_run_equal(got, want, exact):
    """``run()`` results: rows and groups exact; aggregates exact for
    integer-valued (tree-head) sums, else rtol 1e-5 with atol 1e-5 of the
    aggregate's largest magnitude (row sums in another order)."""
    assert int(got["rows"]) == int(want["rows"])
    assert set(got) == set(want)
    if "groups" in want:
        np.testing.assert_array_equal(to_np(got["groups"]),
                                      to_np(want["groups"]))
    for k in want:
        if k in ("rows", "groups"):
            continue
        g, w = to_np(got[k]), to_np(want[k])
        assert g.shape == w.shape, k
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=1e-5 * max(np.abs(w).max(), 1.0),
                                       err_msg=k)


def assert_preds_equal(got, want, exact):
    """Prediction matrices: exact for tree heads; rtol 1e-6 (1 ulp) for
    linear heads with atol 1e-6 of the matrix's largest magnitude, since a
    fused row sums partials that each carry their own ulp."""
    g, w = to_np(got), to_np(want)
    assert g.shape == w.shape and g.dtype == np.float32
    if exact:
        np.testing.assert_array_equal(g, w)
    else:
        scale = np.nanmax(np.abs(w), initial=1.0)
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * scale)


def check_predictive_case(name, backend, join, agg, serve, tables, ref_cat,
                          ref_plans):
    """One P-query plan of the backend matrix against the reference:
    ``run()``, ``predictions()``, and ``predict_rows`` on in-range ids
    (against the same reference serve backend) and out-of-range ids
    (against the reference's plain ``jnp`` backend only)."""
    port_serve, ref_serve = serve
    kw = dict(backend=backend, join_backend=join, agg_backend=agg)
    want = ref_plan(ref_plans, ref_cat, name, serve_backend=ref_serve, **kw)
    got = compile_query(tables, QUERY_IR[name](), serve_backend=port_serve,
                        **kw)
    tree = is_tree(name)
    expect_serve = ("kernel" if port_serve == "kernel"
                    and (backend == "fused" or tree) else "torch")
    assert got.serve_backend == expect_serve
    assert_run_equal(got.run(), want.run(), exact=tree)
    assert_preds_equal(got.predictions(), want.predictions(), exact=tree)

    n = ref_cat["lineorder"].capacity
    inside = np.array([0, 1, 7, n - 1, -1, -n, n // 2], np.int32)
    assert_preds_equal(got.predict_rows(torch.from_numpy(inside)),
                       want.predict_rows(jnp.asarray(inside)), exact=tree)
    outside = np.array([n, n + 5, -n - 1, 3, 10**6], np.int32)
    # The reference's predict_rows reads neither the join nor the
    # aggregation backend, so one plain plan per (query, backend) serves.
    plain = (want if ref_serve == "jnp" else
             ref_plan(ref_plans, ref_cat, name, serve_backend="jnp",
                      backend=backend, join_backend="gather",
                      agg_backend="segment"))
    out = got.predict_rows(torch.from_numpy(outside))
    assert_preds_equal(out, plain.predict_rows(jnp.asarray(outside)),
                       exact=tree)
    if not tree:
        assert np.isnan(to_np(out)[[0, 1, 2, 4]]).all()
