"""The port's training driver (``repro_torch.launch.train.train``) on four
``gloo`` ranks, on the ``(4, 1)`` host mesh of the default process group:
the smoke smollm-360m (fp32) at batch 8 × 32, its parameters, AdamW state
and batch DTensors placed by ``param_shardings``, checkpoints of each
rank's shards.  The checks (``torch_train_mesh_checks.py``) hold it to the
one-process driver, to itself across a resume, and to the reference's
``TokenPipeline`` rows and ``CheckpointManager.restore``.

The ranks run in a subprocess (``torch_train_mesh_worker.py``), since a
process has one default process group.
"""
import pytest

from torch_train_mesh_checks import run_worker
from torch_train_mesh_checks import *  # noqa: F401,F403  (the tests)


@pytest.fixture(scope="module")
def train_mesh(tmp_path_factory):
    return run_worker(tmp_path_factory.mktemp("train_mesh"), 1)
