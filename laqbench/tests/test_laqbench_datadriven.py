"""A configuration, a traffic mix, a cell and a metric added as new files
only (and entries in BENCHMARK.json): the harness finds and runs them."""
import json
import os
import shutil
import subprocess
import sys

from laqbench import spec

ROOT = spec.ROOT


def _write(path, obj):
    path.write_text(json.dumps(obj) if not isinstance(obj, str) else obj)


def test_new_files_only(tmp_path):
    shutil.copytree(ROOT / "laqbench", tmp_path / "laqbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "src", tmp_path / "src")
    before = {p: p.read_bytes() for p in (tmp_path / "laqbench").rglob("*")
              if p.is_file()}
    lb = tmp_path / "laqbench"
    _write(lb / "configs" / "ssb-tiny.json", {
        "name": "ssb-tiny", "source": "SSB at a test's size",
        "generator": "ssb", "precision": "float32",
        "rows": {"lineorder": 20000, "part": 400, "supplier": 40,
                 "customer": 300, "date": 2556},
        "schema": spec.load("configs", "ssb-sf10")["schema"]})
    _write(lb / "traffic" / "q1q4.json", {
        "loop": "closed_rounds", "queries": ["Q1.1", "Q4.1"],
        "warmup_rounds": 1, "profile_seconds": 0.2, "timing_reps": 2})
    _write(lb / "workloads" / "tiny.q1q4.json", {
        "config": "ssb-tiny", "traffic": "q1q4",
        "limits": {"sum_gap": 1e-5}})
    _write(lb / "metrics" / "answers_per_s.py",
           '"""Answered queries a second."""\n\n\ndef read(run):\n'
           '    return run.answered / run.window_s\n')
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ssb-tiny", "source": "SSB",
                             "file": "laqbench/configs/ssb-tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.q1q4", "config": "ssb-tiny",
                               "traffic": "q1q4", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({
        "name": "answers_per_s", "unit": "queries/s", "better": "higher",
        "source": "host_clock", "layer": "query executor",
        "moves": "queries_per_s", "workloads": ["tiny.q1q4"]})
    _write(tmp_path / "BENCHMARK.json", json.dumps(bench))
    for p, data in before.items():      # nothing that was there changed
        assert p.read_bytes() == data
    code = ("import sys, time, json; sys.path[:0] = ['src', '.']\n"
            "from laqbench import harness\n"
            "for tr in (False, True):\n"
            "    print(json.dumps(harness.run_cell('tiny.q1q4', 5, 0.3, tr,"
            " 'cpu', time.perf_counter())))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [json.loads(s) for s in p.stdout.splitlines()
             if s.startswith('{"correct"')]
    plain, traced = lines
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"queries_per_s", "query_p95_ms",
                                     "setup_s"}
    assert traced["metrics"]["answers_per_s"]["value"] > 0
    assert "head_roofline" not in traced["metrics"]
