"""The port's SSB demo (``examples/torch_ssb_demo.py --device cpu``) beside
the reference's (``examples/ssb_demo.py``) at the same arguments: every
query prints the same ``rows=`` and ``groups=``, its total within rtol
1e-5, and the decoded Q2.1 head is the same.

Both demos run as subprocesses, side by side, as a user would run them.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.data import QUERIES

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--scale", "0.002"]
LINE = re.compile(r"^(?P<name>\S+): rows=\s*(?P<rows>\d+) +"
                  r"(?:groups=\s*(?P<groups>\d+) +)?"
                  r"(?P<key>\w+)_total=(?P<total>\S+)")


def _parse(stdout: str) -> dict:
    out = {}
    for line in stdout.splitlines():
        m = LINE.match(line)
        if m:
            out[m["name"]] = m.groupdict()
        elif line.startswith("Q2.1 head:"):
            out["head"] = line
    return out


@pytest.fixture(scope="module")
def demos(tmp_path_factory):
    # One intra-op thread each: the two run side by side, beside the other
    # test workers.
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
           "TMPDIR": str(tmp_path_factory.mktemp("demos"))}
    procs = {
        "port": subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / "torch_ssb_demo.py"),
             "--device", "cpu", *ARGS], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True),
        "ref": subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / "ssb_demo.py"), *ARGS],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)}
    out = {}
    for side, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{side}: {stderr[-3000:]}"
        out[side] = _parse(stdout)
    return out


@pytest.mark.parametrize("name", list(QUERIES))
def test_query_line_matches_the_reference_demo(demos, name):
    port, ref = demos["port"][name], demos["ref"][name]
    for field in ("rows", "groups", "key"):
        assert port[field] == ref[field], (field, port, ref)
    np.testing.assert_allclose(float(port["total"]), float(ref["total"]),
                               rtol=1e-5)


def test_q21_head_matches_the_reference_demo(demos):
    assert demos["port"]["head"] == demos["ref"]["head"]
    assert set(demos["port"]) == set(demos["ref"]) == set(QUERIES) | {"head"}
