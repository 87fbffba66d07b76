"""``test_torch_train_mesh.py``'s checks on the ``(2, 2)`` host mesh: two
data positions of two model shards each, so each pair of ranks reads the
same rows of the global batch and the parameters are split over the
model axis too (the worker sets ``model_parallel=2``; the driver has no
such knob).
"""
import pytest

from torch_train_mesh_checks import run_worker
from torch_train_mesh_checks import *  # noqa: F401,F403  (the tests)


@pytest.fixture(scope="module")
def train_mesh(tmp_path_factory):
    return run_worker(tmp_path_factory.mktemp("train_mesh"), 2)
