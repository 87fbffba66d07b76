"""The port's LM sharded on a (2, 2) ``gloo`` DeviceMesh equals the LM on
plain tensors: the forward of the smoke smollm-360m (15 heads' smoke
counterpart, 3 heads on a 2-wide model axis: the uneven split), of the
smoke qwen2-moe-a2.7b (the MoE's local dispatch and combine), and of
smollm at 1280 positions (the flash path, its blocks on each position's
shards).

Four CPU processes run in a subprocess (``torch_mesh_worker.py``), since
a process has one default process group; each places the parameters by
``param_shardings`` and the batch over the data axis and compares the
gathered logits and aux loss with the plain forward's.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CASES = ["smollm-360m:forward:64", "qwen2-moe-a2.7b:forward:64",
         "smollm-360m:forward:1280"]


def run_worker(tmp_path, cases):
    out = tmp_path / "out.json"
    res = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_worker.py"),
         str(tmp_path / "store"), str(out)] + cases,
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_worker(tmp_path_factory.mktemp("mesh"), CASES)


@pytest.mark.parametrize("case", CASES)
def test_sharded_forward_equals_plain(results, case):
    assert results[case]["max_abs"] <= 1e-5, results[case]
