"""A whole run on the CPU at a small scale: the result line holds exactly
its keys, ``checks`` last, and the command refuses to run without a card
or without the program."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from laqbench import harness, spec

ROOT = spec.ROOT
SCALE = {"ssb-sf10": 0.0005, "synth-s1-sf8": 0.001}


def small_run(workload, trace, seconds=0.3, **kw):
    cfg = spec.cell(workload)["config"]["name"]
    return harness.run_cell(workload, 2**31 + 12345, seconds, trace, "cpu",
                            time.perf_counter(), scale=SCALE[cfg], **kw)


CHECKS = {"ssb10.predictive": {"sum_gap", "leaf_count_gap"},
          "s1sf8.tree7": {"leaf_count_gap"}}


@pytest.mark.parametrize("workload", ["ssb10.predictive", "s1sf8.tree7"])
def test_result_keys(workload):
    out = small_run(workload, False)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    bench = spec.benchmark()
    assert set(out["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(out["checks"]) == {"unanswered", "wrong_rows",
                                  "wrong_groups"} | CHECKS[workload]
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.loads(json.dumps(out, allow_nan=False))


def test_traced_result_keys():
    # a window that outlasts the profiled slice (2 s), past which
    # query_mfu reads its latencies
    out = small_run("ssb10.predictive", True, seconds=4.0)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in out["breakdown"].values())
    # the CPU has no device trace: only host and event readings appear
    assert set(out["metrics"]) == {"compile_ms", "query_mfu",
                                   "head_roofline"}
    json.loads(json.dumps(out, allow_nan=False))


def _cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "laqbench/run.py", "--workload", "ssb10.predictive",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=120, env=env)


def test_cli_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _cli(ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_without_the_program_nothing_runs(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "laqbench", tmp_path / "laqbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path[:0] = ['.']; "
            "from laqbench import harness; "
            "harness.run_cell('ssb10.predictive', 1, 0.1, False, 'cpu', "
            "time.perf_counter(), scale=0.0005)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120, env=env)
    assert p.returncode != 0
    assert "repro_torch" in p.stderr
    assert _cli(tmp_path, env).returncode != 0
