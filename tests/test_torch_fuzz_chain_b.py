"""The reference's randomized workload fuzzer on the port: the chained
seeds, second half (see ``test_torch_fuzz_chain.py`` for what each case
checks)."""
import pytest

from torch_parity import CHAIN_SEEDS, check_chain_seed

HALF = len(CHAIN_SEEDS) // 2


@pytest.mark.parametrize("i", range(HALF, len(CHAIN_SEEDS)),
                         ids=lambda i: str(CHAIN_SEEDS[i]))
def test_chained_case_matches_numpy_oracle(i):
    check_chain_seed(i)
