"""Port parity of the train step for jamba-1.5-large-398b (Mamba and
attention with MoE): loss, gradients and the AdamW-updated parameters
against the reference's, as ``test_torch_train_step.py`` says
(``check_parity``, its tolerances).
"""
import pytest

from test_torch_train_step import check_parity


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b"])
def test_train_step_matches_reference(arch):
    check_parity(arch)
