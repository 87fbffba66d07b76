"""``correct`` comes out false when the timed path is broken underneath,
once for each fault a query cell can have, and for the bfloat16 control;
the harness runs on the CPU at a small size, past its look for a card."""
import time

import pytest
import torch

from laqbench import harness, program, spec

CELLS = ["ssb10.predictive", "ssb10.ssb13", "s1sf8.linear128",
         "s1sf8.tree7"]
SCALE = {"ssb-sf10": 0.001, "synth-s1-sf8": 0.001}


def _run(workload, **kw):
    cfg = spec.cell(workload)["config"]["name"]
    return harness.run_cell(workload, 77, 0.2, False, "cpu",
                            time.perf_counter(), scale=SCALE[cfg], **kw)


def _broken(monkeypatch, breaker):
    real = program.compile_all

    def compile_all(*args, **kw):
        plans, ms = real(*args, **kw)
        for plan in plans.values():
            breaker(plan)
        return plans, ms
    monkeypatch.setattr(program, "compile_all", compile_all)


def _half_rows(plan):
    """Half of the fact rows left out, the sums scaled up to the rest."""
    inner = plan._run

    def run(state):
        keep = torch.arange(state["valid"].shape[0]) % 2 == 0
        out = inner({**state, "valid": state["valid"] & keep})
        return {k: v * 2 if v.is_floating_point() else v
                for k, v in out.items()}
    plan._run = run


def _altered(plan):
    """One aggregate of each answer altered where it is produced."""
    inner = plan._run

    def run(state):
        out = dict(inner(state))
        for k, v in out.items():
            if v.is_floating_point():
                v = v.clone()
                v.view(-1)[0] = v.view(-1)[0] * 1.01 + 1.0
                out[k] = v
                break
        return out
    plan._run = run


def _misrouted(plan):
    """A tree head that sends one row of each answer's first group to
    another leaf: every sum over the leaves is kept."""
    inner = plan._run

    def run(state):
        out = dict(inner(state))
        v = out["prediction"].clone()
        row = v.reshape(-1, v.shape[-1])[0]
        src = int(torch.argmax(row))
        row[src] -= 1
        row[(src + 1) % row.shape[0]] += 1
        out["prediction"] = v
        return out
    plan._run = run


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct_and_control_is_not(workload):
    out = _run(workload, control=True)
    assert out["correct"] is True
    assert out["control"]["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [_half_rows, _altered],
                         ids=["half_rows", "altered_answer"])
def test_fault_is_caught(monkeypatch, workload, fault):
    _broken(monkeypatch, fault)
    out = _run(workload)
    assert out["correct"] is False
    assert out["failed"] > 0


@pytest.mark.parametrize("workload", ["ssb10.predictive", "s1sf8.tree7"])
def test_misrouted_tree_rows_are_caught(monkeypatch, workload):
    real = program.compile_all

    def compile_all(tables, specs, drawn, device):
        plans, ms = real(tables, specs, drawn, device)
        for q, plan in plans.items():
            if q in drawn and drawn[q]["kind"] == "tree":
                _misrouted(plan)
        return plans, ms
    monkeypatch.setattr(program, "compile_all", compile_all)
    out = _run(workload)
    assert out["correct"] is False
    assert out["checks"]["leaf_count_gap"]["value"] == 1
    if "sum_gap" in out["checks"]:       # the linear queries stay sound
        assert (out["checks"]["sum_gap"]["value"]
                <= out["checks"]["sum_gap"]["limit"])
