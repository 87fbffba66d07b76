"""``test_torch_init.py``'s comparison of ``LM.init`` with the
reference's, bit for bit, for the other five archs of the smoke
configs."""
import pytest

from test_torch_init import ARCHS, check_arch


@pytest.mark.parametrize("arch", ARCHS[5:])
def test_init_matches_reference(arch):
    check_arch(arch)
