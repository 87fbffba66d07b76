#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root, one card

Phases, each printing one JSON object per line (any failure raises and the
script exits non-zero, printing no final result):

  1. device + build — needs CUDA and compute capability 9.0; prints the
     card's name and power limit as ``nvidia-smi`` gives them; builds the
     kernels from ``src/repro_torch/kernels/csrc`` with ``nvcc``.
  2. kernels vs plain versions on the card — edge shapes, then the paper's
     widest models at ``data/synthetic.py`` sizes (Table 4, scale 1.0).
     Equality is exact (NaN equal to NaN in the same places).
  3. small check — every registry query at SSB ``scale=0.0005`` on the card
     against the same query on the CPU (the plain path the CPU tests hold
     against the JAX package).
  4. main path — SSB at SF 10 (60M lineorder rows) on the card: every
     registry query compiled with the planner's choices and run; P1–P4 with
     ``backend`` fused and nonfused under ``serve_backend="kernel"`` held
     against the same plan under ``"torch"``.  The kernels' launch counters
     are zeroed just before and read just after; both must have launched.
  5. the kernels line (timed at the main path's shapes), then the device
     line.

The script imports only torch, numpy and the port.  It exits non-zero
without a result when no CUDA device is present or when ``src/repro_torch``
is missing beside it.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

SF = 10                       # main path scale factor (60M fact rows)
ROW_BATCH = 4096              # predict_rows batch on the main path
LINEAR_AGG_RTOL = 1e-5        # index_add_ on CUDA sums with atomics


def emit(**obj):
    print(json.dumps(obj), flush=True)


def same(a, b) -> bool:
    """Exact equality with NaN equal to NaN in the same places."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    both_nan = torch.isnan(a) & torch.isnan(b)
    return bool(((a == b) | both_nan).all())


def max_abs_err(a, b) -> float:
    import torch
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not bool(fin.any()):
        return 0.0
    return float((a[fin] - b[fin]).abs().max())


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of one call, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def host_ms(fn) -> float:
    """Host-clock time of work that ends in a synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


# ------------------------------------------------------------- yardsticks
def gather_bytes_ops(ptrs, tables, h):
    """fused_star_gather: each input read once, the output written once."""
    J, n = ptrs.shape
    l = tables[0].shape[1]
    nbytes = J * n * 4 + J * n + sum(t.numel() * 4 for t in tables)
    nbytes += (l * 4 if h is not None else 0) + n * l * 4
    return nbytes, n * l * J


def tree_bytes_ops(x, F, H):
    """tree_predict: the work the function needs.  F's columns are one-hot,
    so a predicate is one gather per (row, node) plus one finiteness test
    per feature (n·(p+k)); the scores are a (n, p)·(p, l) product."""
    n, k = x.shape
    p, l = H.shape
    nbytes = (n * k + k * p + p + p * l + l + n * l) * 4
    return nbytes, 2 * n * p * l + n * (p + k)


def bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def embedding_bag_call(ptrs, founds, tables):
    """One PyTorch call computing the linear gather-sum: embedding_bag over
    the concatenated partials (a yardstick only; the port never calls it)."""
    import torch
    import torch.nn.functional as F
    offsets, off = [], 0
    for t in tables:
        offsets.append(off)
        off += t.shape[0]
    weight = torch.cat(list(tables))
    idx = (ptrs.long() + torch.tensor(offsets, device=ptrs.device)[:, None]
           ).T.contiguous()
    w = founds.T.to(torch.float32).contiguous()
    return lambda: F.embedding_bag(idx, weight, mode="sum",
                                   per_sample_weights=w)


# ------------------------------------------------------------------ phases
def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA card")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability 9.0 "
                         f"(Hopper), found {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit(phase="device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), capability=list(cap),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.load()
    seconds = time.perf_counter() - t0
    log = _build.build().with_suffix(".log")
    ptxas = [ln.strip() for ln in (log.read_text().splitlines()
                                   if log.exists() else [])
             if "registers" in ln or "spill" in ln]
    emit(phase="build", seconds=round(seconds, 3), ptxas=ptxas)


def check_gather(label, ptrs, founds, tables, h=None, timing=False,
                 library=False):
    from repro_torch.kernels import fused_star_gather, fused_star_gather_ref
    got = fused_star_gather(ptrs, founds, tables, h)
    want = fused_star_gather_ref(ptrs, founds, tables, h)
    import torch
    torch.cuda.synchronize()
    if not same(got, want):
        raise AssertionError(f"fused_star_gather {label}: kernel != plain "
                             f"(max abs err {max_abs_err(got, want)})")
    row = dict(phase="kernel", kernel="fused_star_gather", case=label,
               J=int(ptrs.shape[0]), n=int(ptrs.shape[1]),
               l=int(tables[0].shape[1]), compare=h is not None,
               equal=True, max_abs_err=max_abs_err(got, want))
    if timing:
        nbytes, ops = gather_bytes_ops(ptrs, tables, h)
        row.update(
            bytes=nbytes, operations=ops,
            kernel_ms=time_ms(lambda: fused_star_gather(ptrs, founds, tables,
                                                        h)),
            plain_ms=time_ms(lambda: fused_star_gather_ref(ptrs, founds,
                                                           tables, h)),
            bound_ms=bound(nbytes, ops)[0], bound_by=bound(nbytes, ops)[1],
            library_ms=(time_ms(embedding_bag_call(ptrs, founds, tables))
                        if library else None),
            launches=fused_star_gather.launches)
    emit(**row)
    return row


def check_tree(label, x, tree, timing=False):
    from repro_torch.kernels import tree_predict, tree_predict_ref
    import torch
    args = (x, tree.F, tree.v, tree.H, tree.h)
    got = tree_predict(*args)
    want = tree_predict_ref(*args)
    torch.cuda.synchronize()
    if not same(got, want):
        raise AssertionError(f"tree_predict {label}: kernel != plain "
                             f"(max abs err {max_abs_err(got, want)})")
    row = dict(phase="kernel", kernel="tree_predict", case=label,
               n=int(x.shape[0]), k=tree.k, p=tree.p, l=tree.l, equal=True,
               max_abs_err=max_abs_err(got, want))
    if timing:
        nbytes, ops = tree_bytes_ops(x, tree.F, tree.H)
        row.update(bytes=nbytes, operations=ops,
                   kernel_ms=time_ms(lambda: tree_predict(*args)),
                   plain_ms=time_ms(lambda: tree_predict_ref(*args)),
                   bound_ms=bound(nbytes, ops)[0],
                   bound_by=bound(nbytes, ops)[1], library_ms=None,
                   launches=tree_predict.launches)
    emit(**row)
    return row


def phase_kernel_edges(dev):
    import numpy as np
    import torch
    from repro_torch.core.fusion import random_tree
    rng = np.random.default_rng(0)
    for n in (0, 1, 1000):
        for J in (1, 3):
            for l in (1, 3, 129):
                rows = [int(r) for r in rng.integers(1, 50, size=J)]
                tables = [torch.from_numpy(
                    rng.normal(size=(r, l)).astype(np.float32)).to(dev)
                    for r in rows]
                tables[-1][0, 0] = float("nan")      # NaN in a partial
                ptrs = torch.from_numpy(np.stack(
                    [rng.integers(-2, r + 2, size=n) for r in rows]
                ).astype(np.int32)).to(dev)          # out-of-range pointers
                founds = torch.from_numpy(
                    rng.random((J, n)) < 0.8).to(dev)    # misses
                check_gather(f"edge n={n} J={J} l={l}", ptrs, founds, tables)
                itables = [t.nan_to_num(0.0).round() for t in tables]
                h = torch.from_numpy(rng.integers(-1, 2, size=l).astype(
                    np.float32)).to(dev)
                check_gather(f"edge n={n} J={J} l={l} h", ptrs, founds,
                             itables, h)
    # The depth-13 tree (p=8191, l=8192, in the planner's bounds) takes the
    # 4-rows-per-thread kernel, the others the 16.
    for k, depth in ((5, 1), (5, 3), (128, 7), (5, 13)):
        for n in (0, 1, 1000):
            tree = random_tree(rng, k, depth).to(dev)
            x = torch.from_numpy(rng.normal(size=(n, k)).astype(
                np.float32)).to(dev)
            if n > 3:
                x[1, 0] = float("nan")
                x[2, 4] = float("inf")
            check_tree(f"edge depth={depth} n={n}", x, tree)


def phase_kernel_paper(dev):
    """The paper's widest models at data/synthetic.py sizes (scale 1.0)."""
    import numpy as np
    import torch
    from repro_torch.core.fusion import LinearOperator, prefuse, random_tree
    from repro_torch.core.laq import stack_joins
    from repro_torch.data import generate_star
    for setting, sf, k, l, depth in ((1, 8, 128, 128, 7),
                                     (2, 2, 512, 2048, 9)):
        syn = generate_star(setting, sf, k, seed=setting, scale=1.0,
                            device=dev)
        star = syn.star
        ptrs, founds = stack_joins(star.joins)
        rng = np.random.default_rng(setting)
        lin = LinearOperator(torch.from_numpy(
            (rng.normal(size=(k, l)) / np.sqrt(k)).astype(np.float32))).to(dev)
        pre = prefuse(star, lin)
        check_gather(f"setting {setting} sf {sf} linear k={k} l={l}", ptrs,
                     founds, list(pre.partials), timing=True, library=True)
        del pre
        tree = random_tree(rng, k, depth).to(dev)
        tpre = prefuse(star, tree)
        check_gather(f"setting {setting} sf {sf} tree k={k} depth={depth}",
                     ptrs, founds, list(tpre.partials), tpre.h, timing=True)
        del tpre
        x = star.materialize()
        check_tree(f"setting {setting} sf {sf} tree k={k} depth={depth}", x,
                   tree, timing=True)
        del x, star, syn, ptrs, founds
        torch.cuda.empty_cache()


def _assert_run(got, want, exact, what):
    import torch
    assert set(got) == set(want), what
    assert int(got["rows"]) == int(want["rows"]), what
    for key, w in want.items():
        g = got[key].to(w.device)
        if key in ("rows", "groups") or exact:
            assert same(g, w), f"{what}: {key} differs"
        elif not torch.allclose(g, w, rtol=LINEAR_AGG_RTOL,
                                atol=LINEAR_AGG_RTOL
                                * float(w.abs().max().clamp(min=1.0))):
            raise AssertionError(f"{what}: {key} differs beyond rtol "
                                 f"{LINEAR_AGG_RTOL}")


def _finite_outputs(res, what):
    import torch
    for key, v in res.items():
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{what}: non-finite {key}")


def phase_small_check(dev):
    """Every registry query on the card vs the same query on the CPU."""
    import torch
    from repro_torch.core.fusion import DecisionTreeGEMM
    from repro_torch.core.query import compile_query
    from repro_torch.data import QUERY_IR, generate_ssb
    gpu = generate_ssb(sf=1, scale=0.0005, seed=5, device=dev).tables()
    cpu = generate_ssb(sf=1, scale=0.0005, seed=5, device="cpu").tables()
    for name, build in QUERY_IR.items():
        q = build()
        g = compile_query(gpu, q)
        c = compile_query(cpu, q)
        tree = isinstance(q.model, DecisionTreeGEMM)
        got = {k: v.cpu() for k, v in g.run().items()}
        _assert_run(got, c.run(), tree, f"small {name}")
        _finite_outputs(got, f"small {name}")
        if q.model is not None:
            pg, pc = g.predictions().cpu(), c.predictions()
            ok = (same(pg, pc) if tree else torch.allclose(
                pg, pc, rtol=1e-6, atol=1e-6 * float(pc.abs().max())))
            assert ok, f"small {name}: predictions differ from the CPU"
        emit(phase="small_check", query=name, serve=g.serve_backend,
             backend=g.backend, agrees_with_cpu=True)


def launches_of(fn) -> dict:
    """Kernel launches one call of ``fn`` makes, by kernel."""
    from repro_torch.kernels import fused_star_gather, tree_predict
    before = (fused_star_gather.launches, tree_predict.launches)
    fn()
    return {"fused_star_gather": fused_star_gather.launches - before[0],
            "tree_predict": tree_predict.launches - before[1]}


def phase_main(dev):
    """The port's main path at SF ``SF``: returns the kernels' launch counts
    and their inputs taken from it, for the kernels line."""
    import numpy as np
    import torch
    from repro_torch.core.fusion import DecisionTreeGEMM
    from repro_torch.core.query import compile_query
    from repro_torch.data import (QUERY_IR, generate_ssb,
                                  predictive_query_names)
    from repro_torch.kernels import fused_star_gather, tree_predict

    t0 = time.perf_counter()
    data = generate_ssb(sf=SF, scale=1.0, seed=0, device=dev)
    torch.cuda.synchronize()
    tables = data.tables()
    emit(phase="main_data", sf=SF, lineorder_rows=data.lineorder.capacity,
         part_rows=data.part.capacity, seconds=time.perf_counter() - t0,
         device_bytes=torch.cuda.memory_allocated())

    n = data.lineorder.capacity
    rng = np.random.default_rng(1)
    ids = rng.integers(0, n, size=ROW_BATCH)
    ids[:8] = [n, n + 5, -1, -n, -n - 1, 2**31 - 1, -(2**31), n - 1]
    row_ids = torch.from_numpy(ids.astype(np.int64)).to(dev)
    shapes = {}

    fused_star_gather.launches = 0
    tree_predict.launches = 0
    for name, build in QUERY_IR.items():
        q = build()
        t = time.perf_counter()
        plan = compile_query(tables, q)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t
        res = {}
        run_ms = host_ms(lambda: res.update(plan.run()))
        _finite_outputs(res, name)
        row = dict(phase="main_query", query=name, backend=plan.backend,
                   join=plan.join_backend, agg=plan.agg_backend,
                   serve=plan.serve_backend, compile_s=compile_s,
                   run_ms=run_ms, rows=int(res["rows"]))
        if q.model is not None:
            row["predictions_ms"] = host_ms(plan.predictions)
            row["predict_rows_ms"] = host_ms(lambda: plan.predict_rows(
                row_ids))
        emit(**row)
        del plan, res

    for name in predictive_query_names():
        q = QUERY_IR[name]()
        tree = isinstance(q.model, DecisionTreeGEMM)
        for backend in ("fused", "nonfused"):
            plans = {s: compile_query(tables, q, backend=backend,
                                      serve_backend=s)
                     for s in ("kernel", "torch")}
            k, p = plans["kernel"], plans["torch"]
            # The kernels line times each kernel on the inputs the main
            # path gave it: the first fused plan, the first nonfused tree.
            if backend == "fused" and "fused_star_gather" not in shapes:
                shapes["fused_star_gather"] = (
                    name, k._state["ptrs"], k._state["founds"],
                    list(k._state["partials"]), k._state["h"])
            if tree and backend == "nonfused" and "tree_predict" not in shapes:
                shapes["tree_predict"] = (name, k.star.materialize(),
                                          k.query.model)
            times = {}
            outs = {}
            for s, plan in plans.items():
                res = {}
                times[f"{s}_run_ms"] = host_ms(lambda: res.update(plan.run()))
                outs[s] = res
            _assert_run(outs["kernel"], outs["torch"], tree,
                        f"{name} {backend} run")
            pk = {}
            times["kernel_predictions_ms"] = host_ms(
                lambda: pk.update(v=k.predictions()))
            pt = {}
            times["torch_predictions_ms"] = host_ms(
                lambda: pt.update(v=p.predictions()))
            assert same(pk["v"], pt["v"]), f"{name} {backend} predictions"
            rk, rt = k.predict_rows(row_ids), p.predict_rows(row_ids)
            assert same(rk, rt), f"{name} {backend} predict_rows"
            per_call = {call: launches_of(fn) for call, fn in (
                ("run", k.run), ("predictions", k.predictions),
                ("predict_rows", lambda: k.predict_rows(row_ids)))}
            emit(phase="main_kernel_vs_torch", query=name, backend=backend,
                 serve=k.serve_backend, predictions_equal=True,
                 predict_rows_equal=True,
                 run_equal="exact" if tree else f"rtol {LINEAR_AGG_RTOL}",
                 kernel_launches_per_call=per_call, **times)
            del plans, k, p, outs, pk, pt, rk, rt
        torch.cuda.empty_cache()
    launches = {"fused_star_gather": fused_star_gather.launches,
                "tree_predict": tree_predict.launches}
    emit(phase="main_launches", **launches)
    for kname, count in launches.items():
        if count < 1:
            raise AssertionError(f"{kname} never launched on the main path")
    missing = {"fused_star_gather", "tree_predict"} - set(shapes)
    if missing:
        raise AssertionError(f"main path gave no shapes for {missing}")
    return launches, shapes


def phase_kernels_line(launches, shapes):
    name, ptrs, founds, partials, h = shapes["fused_star_gather"]
    g = check_gather(f"main path {name}", ptrs, founds, partials, h,
                     timing=True, library=h is None)
    name, x, tree = shapes["tree_predict"]
    t = check_tree(f"main path {name}", x.contiguous(), tree, timing=True)
    kernels = []
    for row, kname, line in ((g, "fused_star_gather", 53),
                             (t, "tree_predict", 34)):
        tpu = f"src/repro/kernels/{kname}/kernel.py:{line}"
        kernels.append(dict(
            name=kname, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{kname}.cu",
            replaces=tpu, tpu_source=tpu, checked=True,
            launches=launches[kname], max_abs_err=row["max_abs_err"],
            ms=row["kernel_ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], shape_from=row["case"]))
    print(json.dumps({"kernels": kernels}), flush=True)


def main():
    if not (SRC / "repro_torch").is_dir():
        raise SystemExit("chip_smoke: src/repro_torch not found beside this "
                         "script; run it from a checkout of the repository")
    import torch
    phase_device()            # raises before any result without a card
    sys.path.insert(0, str(SRC))
    t0 = time.perf_counter()
    phase_build()
    dev = torch.device("cuda")
    phase_kernel_edges(dev)
    phase_kernel_paper(dev)
    phase_small_check(dev)
    launches, shapes = phase_main(dev)
    phase_kernels_line(launches, shapes)
    emit(phase="done", seconds=time.perf_counter() - t0,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
