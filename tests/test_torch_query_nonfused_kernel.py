"""Port parity: P1–P4 compiled with ``backend="nonfused"`` and
``serve_backend="kernel"`` over gather/matmul join × segment/matmul
aggregation, against the reference's ``compile_query(..., rewrite="off",
serve_backend="pallas")``.  The four ``test_torch_query_<backend>_<serve>``
files together cover the whole backend matrix.

On the CPU the port's kernel path runs each kernel's plain version behind
the same wrapper calls it makes on the card; the reference runs its Pallas
kernels in interpret mode.

``predict_rows`` with in-range ids (negative ones wrap) is held against the
same reference plan; with out-of-range ids only against the reference's
plain ``jnp`` backend, whose semantics (NaN rows for linear heads, zero
rows for fused trees) the port takes on both of its paths.

Tolerances (``torch_parity.check_predictive_case``): exact for tree heads
and for row counts and group codes; rtol 1e-6 (1 ulp) for linear-head
predictions, with atol 1e-6 of the matrix's largest magnitude; rtol 1e-5
for float aggregates summed over rows.
"""
import pytest

from repro.data import predictive_query_names as ref_predictive_names
from torch_parity import check_predictive_case, port_tables, ref_ssb_catalog


@pytest.fixture(scope="module")
def ref_cat():
    return ref_ssb_catalog()


@pytest.fixture(scope="module")
def tables(ref_cat):
    return port_tables(ref_cat)


@pytest.fixture(scope="module")
def ref_plans():
    return {}


@pytest.mark.parametrize("agg", ["segment", "matmul"])
@pytest.mark.parametrize("join", ["gather", "matmul"])
@pytest.mark.parametrize("name", ref_predictive_names())
def test_nonfused_kernel_matches_reference(name, join, agg, tables, ref_cat,
                                           ref_plans):
    check_predictive_case(name, "nonfused", join, agg,
                          ("kernel", "pallas"), tables, ref_cat,
                          ref_plans)
