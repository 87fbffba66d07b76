"""One train step of the port's LM sharded on a (2, 2) ``gloo``
DeviceMesh (two microbatches, AdamW) equals the step on plain tensors:
the loss, the grad norm, the moments and the new parameters of the smoke
smollm-360m and qwen2-moe-a2.7b, gathered whole, within 1e-5.

The first AdamW step moves a parameter by ``lr·g/(|g| + eps)``: where the
gradient is fp32 summation noise (|g| < 1e-6) the two summation orders
move it by up to ``lr``, so those entries of the new parameters are left
out (``torch_mesh_worker.py``); the gradients themselves, through the
first moment, are compared everywhere.
"""
import pytest
from test_torch_mesh import run_worker

CASES = ["smollm-360m:train:32", "qwen2-moe-a2.7b:train:32"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_worker(tmp_path_factory.mktemp("mesh_b"), CASES)


@pytest.mark.parametrize("case", CASES)
def test_sharded_train_step_equals_plain(results, case):
    assert results[case]["max_abs"] <= 1e-5, results[case]
