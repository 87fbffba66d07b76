"""The port's cost analyzer (``repro_torch.launch.hlo_analysis``) against
hand counts: the cases of the reference's ``test_hlo_analysis.py`` that
carry over to an eager trace.

Loops run in the port, so a loop of matmuls counts every trip with no
trip-count bookkeeping; plain ``meta`` tensors are traced here.  The
DTensor cases (collective bytes by kind, a matmul split dp × tp counted
per device, the count above DTensor against ``FlopCounterMode``) run on
``fake`` process groups in a subprocess (``torch_dryrun_worker.py``).
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch.hlo_analysis import COLLECTIVES, trace_costs

ROOT = Path(__file__).resolve().parents[1]
MB = 4.0 * 256 * 512            # a (256, 512) fp32 tensor's bytes


@pytest.fixture(scope="module")
def fake_mesh_cases(tmp_path_factory):
    out = tmp_path_factory.mktemp("costs") / "costs.json"
    tasks = ["costs", "flopcount:smollm-360m:train_4k",
             "flopcount:qwen2-moe-a2.7b:decode_32k"]
    res = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_dryrun_worker.py"),
         str(out)] + tasks, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(out.read_text())


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_loop_of_matmuls_counts_every_trip():
    n_iter, b, d = 7, 32, 64

    def scanned(ws, x):
        for i in range(n_iter):
            x = torch.tanh(x @ ws[i])
        return x

    _, costs, _, global_flops = trace_costs(scanned, _meta(n_iter, d, d),
                                            _meta(b, d))
    assert costs.flops == 2.0 * b * d * d * n_iter
    assert global_flops == costs.flops        # no DTensor: one position


def test_nested_loops():
    def nested(ws, x):
        for i in range(5):
            for _ in range(3):
                x = torch.tanh(x @ ws[i])
        return x

    _, costs, _, _ = trace_costs(nested, _meta(5, 16, 16), _meta(8, 16))
    assert costs.flops == 2.0 * 8 * 16 * 16 * 5 * 3


def test_memory_bytes_match_the_hand_sum():
    n = 1024 * 1024 * 4
    _, costs, mem, _ = trace_costs(lambda x: torch.tanh(x) * 2.0,
                                   _meta(1024, 1024))
    # tanh reads x and writes t, the product reads t and writes y.
    assert costs.mem_bytes == pytest.approx(4 * n, rel=0.05)
    assert mem.argument_bytes == n and mem.output_bytes == n
    assert mem.peak_bytes == 3 * n and mem.temp_bytes == 2 * n
    assert costs.n_collectives == 0 and costs.total_coll_bytes == 0


def test_dtensor_matmul_counts_per_device(fake_mesh_cases):
    c = fake_mesh_cases["costs"]["matmul_dp_tp"]
    glob = 2.0 * 256 * 512 * 1024
    assert c["global_flops"] == glob
    assert c["flops"] == glob / (2 * 4)       # dp × tp
    assert c["n"] == 0 and c["wire"] == 0
    # x (128, 512) and w (512, 256) local, fp32.
    assert c["argument_bytes"] == 4 * (128 * 512 + 512 * 256)


def test_collective_bytes_by_kind(fake_mesh_cases):
    cases = fake_mesh_cases["costs"]
    out = 4.0 * 128 * 1024          # (128, 1024) fp32: a row block of y
    want = {
        # the contraction split 4 ways: a partial sum, all-reduced over 4
        "matmul_reduced": ("all-reduce", out, 2.0 * out * 3 / 4),
        # (128, 256) shards of y gathered over the 4-wide model axis
        "all_gather": ("all-gather", out / 4, out / 4 * 3),
        # the partial sum reduce-scattered over the model axis
        "reduce_scatter": ("reduce-scatter", out, out * 3 / 4),
    }
    for name, (kind, payload, wire) in want.items():
        c = cases[name]
        assert c["n"] == 1, name
        assert c["coll"][kind] == payload, (name, c)
        assert sum(c["coll"].values()) == payload, (name, c)
        assert c["wire"] == pytest.approx(wire), (name, c)
    # x's (128, 512) row block exchanged over the 2-wide data axis
    c = cases["all_to_all"]
    assert c["n"] == 1 and c["coll"]["all-to-all"] == MB / 2, c
    assert c["wire"] == MB / 2, c
    assert set(cases["matmul_reduced"]["coll"]) == set(COLLECTIVES)


@pytest.mark.parametrize("task", ["flopcount:smollm-360m:train_4k",
                                  "flopcount:qwen2-moe-a2.7b:decode_32k"])
def test_count_above_dtensor_is_flop_counter_modes(fake_mesh_cases, task):
    """A smoke-config step on a fake (4, 4) mesh: the analyzer's count
    above DTensor equals ``FlopCounterMode``'s over the same step, and the
    per-device count is below it."""
    c = fake_mesh_cases[task]
    assert c["global_flops"] == c["flop_counter"] > 0
    assert 0 < c["flops"] < c["global_flops"]
