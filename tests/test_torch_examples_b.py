"""The port's other three examples run on the CPU (``--device cpu``) and
print their check lines: ``examples/torch_quickstart.py`` (each section's
assertion — segment == matmul, fused == non-fused, sharded == single
device on a virtual (2, 4) mesh, refreshed == cold, scheduled == serve,
``run_all`` == per-plan runs, streamed == in-core, the snowflake chain
and the rewrite), ``examples/torch_fused_serving.py`` (fused == non-fused
tokens, asserted inside ``run_serving``) and ``examples/torch_train_lm.py
--steps 20`` (the loss improves, and the restart resumes from the
checkpoint for 10 more steps).

The reference's quickstart and train_lm stop under this jax (its
``ShardingTypeError``s), so these have no reference output to match; the
SSB demo's is matched in ``test_torch_examples.py``.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = {
    "torch_quickstart.py": ([], [
        "segment == matmul aggregation ✓",
        "fused == non-fused row predictions ✓",
        "sharded == single-device ✓ on mesh {'data': 2, 'model': 4}",
        "append → refresh ≡ cold rebuild ✓",
        "scheduled serving ✓",
        "run_all over 4 variants ✓",
        "evict → pool drained ✓",
        "streamed == in-core bitwise ✓",
        "≡ cold rebuild ✓",
        "snowflake ✓",
        "sub-dimension append → chain refresh ≡ cold rebuild ✓",
        "rewrite ✓ distill"]),
    "torch_fused_serving.py": ([], [
        "[serve] fusion planner: fuse=True",
        "[serve] batch=4 decode=8 fused p50="]),
    "torch_train_lm.py": (["--steps", "20"], [
        "(improved)",
        "[train] resumed from step 20",
        "resumed and ran 10 more steps"]),
}
CASES = [(name, line) for name, (_, lines) in EXAMPLES.items()
         for line in lines]


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    # One intra-op thread each: the three run side by side, beside the
    # other test workers.
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1",
           "TMPDIR": str(tmp_path_factory.mktemp("examples"))}
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / name), "--device", "cpu",
         *args], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name, (args, _) in EXAMPLES.items()}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        out[name] = (proc.returncode, stdout, stderr)
    return out


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_exits_0(outputs, name):
    code, _, stderr = outputs[name]
    assert code == 0, stderr[-3000:]


@pytest.mark.parametrize("name,line", CASES,
                         ids=[f"{n}:{i}" for i, (n, _) in enumerate(CASES)])
def test_example_prints_its_check(outputs, name, line):
    _, stdout, _ = outputs[name]
    assert any(line in out for out in stdout.splitlines()), stdout[-3000:]
