"""The port's dry run (``repro_torch.launch.dryrun``, ``roofline``) and
its activation constraints' ``_resolve`` on a ``DeviceMesh``, against the
reference.

* ``_resolve`` on the production ``DeviceMesh``es (built in a subprocess
  on a ``fake`` group) gives the reference's axes for every role over a
  range of sizes, its divisibility fallback included.
* ``model_flops`` equals the reference's for every arch and shape.
* The roofline's record has the reference's keys and formulas; its
  constants are the H100's.
* Two smoke-config cells run end to end through the CLI in a subprocess
  (a (4, 4) fake group) with ``status == "ok"``.
* One rank of a fake group (rank 5 and 15 of the (4, 4) smoke mesh, rank
  511 of the multipod mesh) draws per shard exactly the slices of the
  whole draw that rank holds.
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

from repro.configs import arch_ids
from repro.configs import get_config as ref_get_config
from repro.launch import roofline as RR
from repro.models import act_sharding as RA
from repro_torch.configs import get_config
from repro_torch.launch import roofline as TR
from repro_torch.launch import steps as TS
from repro_torch.launch.hlo_analysis import Costs

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _worker(tmp_path, *tasks):
    out = tmp_path / "out.json"
    res = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_dryrun_worker.py"),
         str(out)] + list(tasks), capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(out.read_text())


def test_a_rank_of_a_fake_group_draws_its_slices(tmp_path):
    cases = ("initshard:jamba-1.5-large-398b:smoke:5",
             "initshard:qwen2-moe-a2.7b:smoke:15",
             "initshard:dbrx-132b:multipod:511")
    port = _worker(tmp_path, *cases)
    for case in cases:
        r = port[case]
        assert r["equal"] == r["leaves"] and r["split"] > 0, (case, r)


def test_resolve_on_device_mesh_matches_reference(tmp_path):
    port = _worker(tmp_path, *(f"resolve:{m}" for m in MESHES))
    saved = dict(RA._CTX)
    try:
        for name, (shape, axes) in MESHES.items():
            mesh = types.SimpleNamespace(axis_names=axes,
                                         shape=dict(zip(axes, shape)))
            RA.set_activation_sharding(tuple(a for a in axes
                                             if a != "model"),
                                       "model", mesh)
            rows = port[f"resolve:{name}"]
            assert len(rows) == 36
            fallbacks = 0
            for role, size, got in rows:
                want = RA._resolve(role, size)
                want = list(want) if isinstance(want, tuple) else want
                assert got == want, (name, role, size, got, want)
                fallbacks += role is not None and got is None
            assert fallbacks > 0
    finally:
        RA._CTX.update(saved)


@pytest.mark.parametrize("arch", arch_ids())
def test_model_flops_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for shape in TS.SHAPES:
        assert TR.model_flops(cfg, shape) == RR.model_flops(rcfg, shape)


def test_roofline_record_matches_reference_formulas():
    assert (TR.PEAK_FLOPS, TR.HBM_BW, TR.ICI_BW) == (989e12, 3.35e12, 50e9)
    costs = Costs(flops=3e12, mem_bytes=2e12, wire_bytes=7e9,
                  n_collectives=11)
    costs.coll_bytes["all-gather"] = 5e9
    costs.coll_bytes["all-reduce"] = 1e9
    cfg = get_config("llama3.2-1b")
    roof = TR.analyze_cell("llama3.2-1b", "train_4k", "pod", 256, cfg, costs)
    ref = RR.Roofline(
        arch="llama3.2-1b", shape="train_4k", mesh="pod", n_devices=256,
        flops_per_dev=3e12, mem_bytes_per_dev=2e12, coll_bytes_per_dev=6e9,
        wire_bytes_per_dev=7e9, n_collectives=11,
        coll_by_kind=dict(costs.coll_bytes),
        model_flops_total=RR.model_flops(ref_get_config("llama3.2-1b"),
                                         "train_4k"))
    got, want = roof.to_json(), ref.to_json()
    assert set(got) == set(want)
    assert got["t_compute_s"] == 3e12 / 989e12
    assert got["t_memory_s"] == 2e12 / 3.35e12
    assert got["t_collective_s"] == 6e9 / 50e9
    assert got["bottleneck"] == "memory"
    for k in ("flops_per_dev", "mem_bytes_per_dev", "coll_bytes_per_dev",
              "wire_bytes_per_dev", "n_collectives", "coll_by_kind",
              "model_flops_total"):
        assert got[k] == want[k], k
    assert got["useful_ratio"] == want["useful_ratio"]
    assert got["roofline_fraction"] == pytest.approx(
        got["model_flops_total"] / 256 / 989e12 / got["t_memory_s"])


@pytest.mark.parametrize("arch,shape", [("smollm-360m", "train_4k"),
                                        ("qwen2-moe-a2.7b", "decode_32k")])
def test_smoke_cell_dry_runs(tmp_path, arch, shape):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "smoke", "--outdir", str(tmp_path)],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads((tmp_path / f"{arch}__{shape}__smoke.json").read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_devices"] == 16
    mem, roof = rec["memory"], rec["roofline"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert roof["flops_per_dev"] > 0 and roof["mem_bytes_per_dev"] > 0
    assert roof["n_collectives"] > 0
    assert rec["flop_counter"]["flops"] > roof["flops_per_dev"]
    assert roof["bottleneck"] in ("compute", "memory", "collective")
