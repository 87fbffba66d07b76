"""Port parity of the train step for xlstm-125m (mLSTM and sLSTM): loss,
gradients and the AdamW-updated parameters against the reference's, as
``test_torch_train_step.py`` says (``check_parity``, its tolerances).
"""
import pytest

from test_torch_train_step import check_parity


@pytest.mark.parametrize("arch", ["xlstm-125m"])
def test_train_step_matches_reference(arch):
    check_parity(arch)
