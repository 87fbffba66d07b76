"""Port parity: operator fusion (``repro_torch.core.fusion``) vs
``repro.core.fusion``.

Tolerances:
  * exact — tree arrays from the same seed, tree partials, every fused
    gather-sum given the same partials, every tree one-hot output;
  * rtol 1e-6 (1 ulp) — linear-head prefuse and non-fused linear outputs,
    whose fp32 matmul rounding depends on the library and the shape.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core.fusion as R
import repro_torch.core.fusion as T
from repro.core.laq import DimSpec, Table, star_join
from repro_torch.core.laq import DimSpec as TDimSpec
from repro_torch.core.laq import stack_joins
from repro_torch.core.laq import star_join as t_star_join
from torch_parity import port_model, port_table, to_np


def _stars(seed, n_fact=40, dims_shape=((8, 3), (6, 2), (5, 3))):
    """The same random star in both packages (fact keys miss sometimes)."""
    rng = np.random.default_rng(seed)
    specs, tspecs, fact_cols = [], [], {}
    for d, (n_dim, ncols) in enumerate(dims_shape):
        pk = rng.permutation(n_dim * 2)[:n_dim].astype(np.int32)
        cols = {f"f{j}": rng.normal(size=n_dim).astype(np.float32)
                for j in range(ncols)}
        cols["pk"] = pk
        dim = Table.from_columns(f"dim{d}", cols, key_cols=("pk",))
        fact_cols[f"fk{d}"] = rng.choice(np.concatenate([pk, [999]]),
                                         size=n_fact)
        feats = tuple(f"f{j}" for j in range(ncols))
        specs.append(DimSpec(dim, f"fk{d}", "pk", feats))
        tspecs.append(TDimSpec(port_table(dim), f"fk{d}", "pk", feats))
    fact = Table.from_columns("fact", fact_cols,
                              key_cols=tuple(fact_cols.keys()))
    return (star_join(fact, specs), t_star_join(port_table(fact), tspecs),
            rng)


def _linear(rng, k, l, bias=False):
    L = rng.normal(size=(k, l)).astype(np.float32)
    b = rng.normal(size=l).astype(np.float32) if bias else None
    ref = R.LinearOperator(jnp.asarray(L),
                           None if b is None else jnp.asarray(b))
    return ref, port_model(ref)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_random_tree_same_arrays(depth):
    want = R.random_tree(np.random.default_rng(depth), 6, depth)
    got = T.random_tree(np.random.default_rng(depth), 6, depth)
    for name in ("F", "v", "H", "h"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      to_np(getattr(want, name)))
    assert (got.k, got.p, got.l) == (want.k, want.p, want.l)


def test_tree_apply_equals_traversal_and_reference():
    rng = np.random.default_rng(11)
    feature = rng.integers(0, 5, size=7)
    threshold = rng.normal(size=7).astype(np.float32)
    x = rng.normal(size=(50, 5)).astype(np.float32)
    x[3, 2] = np.nan
    got = T.tree_from_arrays(feature, threshold, 5)
    want = R.tree_from_arrays(feature, threshold, 5)
    out = to_np(got.apply(torch.from_numpy(x)))
    np.testing.assert_array_equal(out, to_np(want.apply(jnp.asarray(x))))
    np.testing.assert_array_equal(
        to_np(got.predict_leaf(torch.from_numpy(x)))[4:],
        T.reference_tree_eval(feature, threshold, x)[4:])
    np.testing.assert_array_equal(
        T.reference_tree_eval(feature, threshold, x),
        R.reference_tree_eval(feature, threshold, x))


@pytest.mark.parametrize("bias", [False, True])
def test_linear_operator_matches_reference(bias):
    rng = np.random.default_rng(12)
    ref, port = _linear(rng, 6, 4, bias)
    x = rng.normal(size=(30, 6)).astype(np.float32)
    np.testing.assert_allclose(to_np(port.apply(torch.from_numpy(x))),
                               to_np(ref.apply(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    ref2, port2 = _linear(rng, 4, 3, bias)
    np.testing.assert_allclose(to_np(port.compose(port2).L),
                               to_np(ref.compose(ref2).L),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("bias", [False, True])
def test_linear_fusion_matches_reference(seed, bias):
    ref_star, star, rng = _stars(seed)
    ref_m, m = _linear(rng, ref_star.feature_width, 3, bias)
    ref_pre = R.prefuse(ref_star, ref_m)
    pre = T.prefuse(star, m)
    for g, w in zip(pre.partials, ref_pre.partials):
        np.testing.assert_allclose(to_np(g), to_np(w), rtol=1e-6, atol=1e-6)
    # Given the same partials, the fused gather-sum is exact.
    same = T.PrefusedStar(tuple(torch.from_numpy(np.array(p))
                                for p in ref_pre.partials), None)
    np.testing.assert_array_equal(to_np(T.predict_fused(star, same)),
                                  to_np(R.predict_fused(ref_star, ref_pre)))
    np.testing.assert_allclose(to_np(T.predict_fused_matmul(star, same)),
                               to_np(R.predict_fused_matmul(ref_star,
                                                            ref_pre)),
                               rtol=1e-6, atol=1e-6)
    for fn_t, fn_r in ((T.predict_nonfused, R.predict_nonfused),
                       (T.predict_nonfused_matmul, R.predict_nonfused_matmul)):
        np.testing.assert_allclose(to_np(fn_t(star, m)),
                                   to_np(fn_r(ref_star, ref_m)),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed,depth", [(0, 1), (1, 2), (2, 3), (3, 3)])
def test_tree_fusion_matches_reference_exactly(seed, depth):
    ref_star, star, _ = _stars(seed)
    ref_m = R.random_tree(np.random.default_rng(seed),
                          ref_star.feature_width, depth)
    m = port_model(ref_m)
    ref_pre = R.prefuse(ref_star, ref_m)
    pre = T.prefuse(star, m)
    for g, w in zip(pre.partials, ref_pre.partials):
        np.testing.assert_array_equal(to_np(g), to_np(w))
    np.testing.assert_array_equal(to_np(pre.h), to_np(ref_pre.h))
    for fn_t, fn_r, arg_t, arg_r in (
            (T.predict_fused, R.predict_fused, pre, ref_pre),
            (T.predict_fused_matmul, R.predict_fused_matmul, pre, ref_pre),
            (T.predict_nonfused, R.predict_nonfused, m, ref_m),
            (T.predict_nonfused_matmul, R.predict_nonfused_matmul, m, ref_m)):
        np.testing.assert_array_equal(to_np(fn_t(star, arg_t)),
                                      to_np(fn_r(ref_star, arg_r)))


def test_kernel_entry_points_on_cpu_tensors_equal_plain():
    """On CPU tensors the kernel entry points take the plain versions."""
    ref_star, star, rng = _stars(5)
    tree = port_model(R.random_tree(rng, star.feature_width, 2))
    _, lin = _linear(rng, star.feature_width, 4)
    ptrs, founds = stack_joins(star.joins)
    for model in (tree, lin):
        pre = T.prefuse(star, model)
        np.testing.assert_array_equal(
            to_np(T.predict_fused_kernel(star, pre, ptrs=ptrs,
                                         founds=founds)),
            to_np(T.predict_fused(star, pre)))
    np.testing.assert_array_equal(to_np(T.predict_nonfused_kernel(star, tree)),
                                  to_np(T.predict_nonfused(star, tree)))


@pytest.mark.parametrize("model_kind", ["linear", "tree"])
@pytest.mark.parametrize("bpu,budget", [(1000.0, None), (0.01, None),
                                        (1000.0, 64)])
def test_plan_fusion_matches_reference(model_kind, bpu, budget):
    rng = np.random.default_rng(9)
    ref = (R.LinearOperator(jnp.asarray(rng.normal(size=(12, 3)),
                                        jnp.float32))
           if model_kind == "linear" else R.random_tree(rng, 12, 4))
    port = port_model(ref)
    for rows, dims in ((10_000, (100, 50, 20)), (50, (5000, 2000, 2555))):
        want = R.plan_fusion(ref, rows, dims, batches_per_update=bpu,
                             memory_budget_bytes=budget, selectivity=0.5)
        got = T.plan_fusion(port, rows, dims, batches_per_update=bpu,
                            memory_budget_bytes=budget, selectivity=0.5)
        assert got == T.FusionDecision(*[getattr(want, f) for f in (
            "fuse", "est_speedup", "amortized_speedup", "prefused_bytes",
            "reason")])
