"""Port parity of the train step for whisper-tiny (frames) and pixtral-12b
(patch embeddings): loss, gradients and the AdamW-updated parameters
against the reference's, as ``test_torch_train_step.py`` says
(``check_parity``, its tolerances).
"""
import pytest

from test_torch_train_step import check_parity


@pytest.mark.parametrize("arch", ["whisper-tiny", "pixtral-12b"])
def test_train_step_matches_reference(arch):
    check_parity(arch)
