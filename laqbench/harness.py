"""One run of one cell: set-up, the measured window, the reference check.

``run_cell`` does everything but look for the card, which ``run.py`` does
before calling it: the tests drive it on the CPU at a small ``scale``.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional

import torch

from . import gen, judge, models, roofline, spec
from . import trace as trace_mod
from .reference import answer

FORBIDDEN = ("jax", "jaxlib", "flax", "ml_dtypes", "repro")


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read."""

    setup_s: float
    window_s: float
    answered: int
    latencies_ms: List[float]
    compile_ms: Dict[str, float]
    trace: Optional[dict] = None
    head: List[dict] = dataclasses.field(default_factory=list)
    names: List[str] = dataclasses.field(default_factory=list)
    least: Dict[str, tuple] = dataclasses.field(default_factory=dict)
    profiled: int = 0


class EventClock:
    """Marks are CUDA events on the current stream."""

    def mark(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    @staticmethod
    def ms(a, b) -> float:
        b.synchronize()
        return a.elapsed_time(b)


class HostClock:
    def mark(self):
        return time.perf_counter()

    @staticmethod
    def ms(a, b) -> float:
        return (b - a) * 1e3


_T0 = [time.perf_counter()]


def emit(**line) -> None:
    """An earlier line of standard output, stamped with the seconds since
    the process started."""
    line["at_s"] = time.perf_counter() - _T0[0]
    print(json.dumps(line), flush=True)


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_reader(name: str):
    path = spec.HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"laqbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def seconds_per_call(fn, device: torch.device, reps: int) -> float:
    """Device seconds of one call: CUDA events around ``reps`` calls after
    two warm-up calls (host clock on the CPU)."""
    for _ in range(2):
        fn()
    if device.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps / 1e3
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) / reps


def card_state(fields: str = "name,power.limit") -> str:
    """``nvidia-smi``'s reading of the card's ``fields``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, t0: float, scale: float = 1.0,
             control: bool = False, marks: Optional[dict] = None) -> dict:
    """Run ``workload`` and return its result line (a dict).

    ``control`` also reads the bfloat16 control's numbers against the
    reference, for setting the limits; the benchmark's own runs never do.
    ``marks`` are seconds since ``t0`` that the caller took before.
    """
    _T0[0] = t0
    emit(line="start", **(marks or {}))
    from . import program   # the system under test
    emit(line="program_imported")
    dev = torch.device(device)
    c = spec.cell(workload)
    cfg, traffic, specs = c["config"], c["traffic"], c["queries"]
    entries = spec.metric_entries(spec.benchmark(), workload, trace)

    t = time.perf_counter()
    program.build_kernels(dev)
    emit(line="kernels", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    raw = gen.generate(cfg, seed, dev, scale)
    rows = {name: rt.n for name, rt in raw.items()}
    program.sync(dev)
    t_gen = time.perf_counter()
    host = gen.to_host(raw)
    del raw
    t_host = time.perf_counter()
    tables = program.tables(host, dev)
    del host
    program.sync(dev)
    t_end = time.perf_counter()
    emit(line="data", config=cfg["name"], rows=rows, seconds=t_end - t,
         generate_s=t_gen - t, to_host_s=t_host - t_gen,
         from_columns_s=t_end - t_host,
         device_bytes=(torch.cuda.memory_allocated(dev)
                       if dev.type == "cuda" else None))
    drawn = {q: models.draw(s["model"], sum(spec.feature_counts(s)))
             for q, s in specs.items() if s["model"] is not None}
    plans, compile_ms = program.compile_all(tables, specs, drawn, dev)
    for q, plan in plans.items():
        emit(line="plan", query=q, compile_ms=compile_ms[q],
             **program.describe(plan))
    loop = importlib.import_module(f"{__package__}.loops.{traffic['loop']}")
    loop.warm(plans, traffic)
    program.sync(dev)
    setup_s = time.perf_counter() - t0
    emit(line="setup", setup_s=setup_s)

    clock = EventClock() if dev.type == "cuda" else HostClock()
    tracer = (trace_mod.Slice(dev, traffic["profile_seconds"]) if trace
              else None)
    win = loop.drive(plans, traffic, seed, seconds, clock, tracer)
    program.sync(dev)
    if tracer is not None:
        tracer.finish()
    done = win["done"]
    widths = {q: models.width(drawn[q]) if q in drawn else 1
              for q in specs}
    record = RunRecord(
        setup_s=setup_s, window_s=win["window_s"],
        answered=sum(1 for d in done if d[3] is not None),
        latencies_ms=[clock.ms(a, b) for _, a, b, _ in done],
        compile_ms=compile_ms,
        trace=tracer.stats if tracer is not None else None,
        names=[q for q, _, _, _ in done],
        least={q: roofline.query_work(s, rows, drawn.get(q), widths[q])
               for q, s in specs.items()},
        profiled=tracer.stats["queries"] if tracer is not None else 0)
    if dev.type == "cuda":
        emit(line="card", after_window=card_state(
            "name,power.limit,power.draw,temperature.gpu,clocks.sm,"
            "clocks.mem"))
    if trace:
        reps = traffic["timing_reps"]
        for q, plan in plans.items():
            if q not in drawn:
                continue
            l = widths[q]
            nbytes, ops = roofline.head_work(specs[q], rows, drawn[q], l)
            least, by = roofline.least_s(nbytes, ops)
            record.head.append({
                "query": q, "least_s": least, "bound_by": by,
                "bytes": nbytes,
                "measured_s": seconds_per_call(plan.predictions, dev,
                                               reps)})
        emit(line="timings", power=card_state(), head=record.head)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    per_query = {}
    for (q, _, _, _), ms in zip(done, record.latencies_ms):
        per_query.setdefault(q, []).append(ms)
    emit(line="window", queries=len(done), window_s=record.window_s,
         per_10s=[sum(1 for e in win["ends_s"] if i <= e / 10 < i + 1)
                  for i in range(math.ceil(record.window_s / 10))],
         median_ms={q: statistics.median(v) for q, v in per_query.items()},
         launches=program.launches(), errors=win["errors"][:5])

    # The reference runs with the program's state freed, on columns drawn
    # again from the seed.
    answers = [(q, None if h is None else {k: v.numpy() for k, v in
                                           h.items()})
               for q, _, _, h in done]
    del plans, tables, done, win
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    raw = gen.generate(cfg, seed, dev, scale)
    wants = {q: answer(raw, s, drawn.get(q)) for q, s in specs.items()}
    verdict = judge.judge(answers, wants, specs, c["workload"]["limits"])
    emit(line="reference", seconds=time.perf_counter() - t,
         compared=verdict["compared"])
    ctl = None
    if control:
        lows = {q: answer(raw, s, drawn.get(q), precision="bfloat16")
                for q, s in specs.items()}
        ctl = judge.judge(
            [(q, _as_output(lows[q], s)) for q, s in specs.items()],
            wants, specs, c["workload"]["limits"])
        emit(line="control", **ctl)
    del raw

    metrics = {}
    for m in entries:
        value = load_reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dinfo = {"platform": "gpu" if dev.type == "cuda" else dev.type,
             "kind": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"),
             "count": 1, "memory_peak_bytes": peak}
    out = {"correct": verdict["correct"], "attempted": len(answers),
           "failed": verdict["failed"], "metrics": metrics,
           "device": dinfo}
    if record.trace is not None:
        dinfo["busy_s"] = record.trace["busy_s"]
        dinfo["window_s"] = record.trace["window_s"]
        out["breakdown"] = {k: record.trace[k]
                            for k in ("device_ops", "idle_gaps")}
    if ctl is not None:
        out["control"] = ctl
    out["checks"] = verdict["checks"]
    return out


def _as_output(a, qspec) -> dict:
    """A reference answer in the program's output form (the control)."""
    codes = []
    for row in a.keys:
        code = 0
        for g, v in zip(qspec["group_by"], row):
            code = code * g["bound"] + int(v) - g.get("offset", 0)
        codes.append(code)
    out = {"rows": a.rows, "groups": codes}
    for name, s in a.sums.items():
        out[name] = s
    return out
