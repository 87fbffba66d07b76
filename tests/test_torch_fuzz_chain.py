"""The reference's randomized workload fuzzer on the port: the chained
seeds, first half (the second half is ``test_torch_fuzz_chain_b.py``).

For each seed of ``torch_parity.CHAIN_SEEDS`` (the seeds among 0–499 whose
generated query has a snowflake chain):

* the port's ``generate_case(seed)`` equals the reference's: the same
  tables and the same query by content;
* the port's ``check_case`` finds no mismatch: every plan's ``run()``
  against the float64 numpy oracle, **bit for bit** (integer-valued data,
  so every float32 sum is exact).  Every 4th seed runs the full matrix, as
  ``run_fuzz`` does — fused/nonfused × segment/matmul, ``rewrite="off"``,
  the append→session-refresh-vs-cold-compile leg and serving — and the rest
  run the quick check (fused and nonfused);
* the rewrite leg: the port's rewrite equals the reference's (trail and
  IR), and the ``rewrite="off"`` plans equal the oracle.

On the CPU the kernel wrappers run their plain versions, so this checks
the port's algebra; ``chip_smoke.py``'s ``fuzz`` phase runs cases on the
card.
"""
import pytest

from repro.core.query.workload import generate_case as ref_generate_case
from torch_parity import CHAIN_SEEDS, check_chain_seed

HALF = len(CHAIN_SEEDS) // 2


def test_seed_list_is_the_chained_seeds():
    assert CHAIN_SEEDS == tuple(
        s for s in range(500)
        if any(a.links for a in ref_generate_case(s).query.arms))
    assert len(CHAIN_SEEDS) == 302


@pytest.mark.parametrize("i", range(HALF), ids=lambda i: str(CHAIN_SEEDS[i]))
def test_chained_case_matches_numpy_oracle(i):
    check_chain_seed(i)
