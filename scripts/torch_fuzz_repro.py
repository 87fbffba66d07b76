#!/usr/bin/env python
"""Replay / drive the port's randomized snowflake fuzzer from the command
line (the port of ``scripts/fuzz_repro.py``, on ``repro_torch``).

Three modes, as the reference's:

``--seed N``
    Replay ONE generated case with the full check matrix — fused/nonfused
    × segment/matmul against the float64 oracle, the ``rewrite="off"``
    plan, the streamed plan, the append→refresh-vs-cold-compile and
    serving checks — and dump the generated schema/query.  Exits nonzero
    on any mismatch.

``--cases K [--base-seed B] [--full-every F]``
    Run a fuzz campaign of K cases.  On mismatch, prints every failure and
    exits nonzero.

Both also run every case's kernels' leg (``check_kernels``, which the
reference has no counterpart of): plans under ``join_backend="gather"``
and ``serve_backend="kernel"`` and ``"kernel"`` serving runtimes, fused
and nonfused, against the numpy oracles bit for bit, so that on the card
the case runs ``fused_star_gather`` and, for a tree, ``tree_predict``.

``--seed N --rewrite-matrix``
    Replay one case through every backend combo with the IR rewrite engine
    on AND off, printing the fired-rule trail and comparing both plans'
    results with the float64 oracle.

``--device`` picks where the tables live and every plan runs: ``cuda`` (the
default; with no card it raises rather than run on the CPU) or ``cpu``.
The last line printed is the kernel launches the run made, as JSON after
``[launches]``: on the card the plans run ``fused_star_gather`` and
``tree_predict``; on the CPU every wrapper runs its plain version and
counts none.  On the card a ``[peak_bytes]`` line before it gives the
peak device memory.

Usage:
    PYTHONPATH=src python scripts/torch_fuzz_repro.py --seed 12345
    PYTHONPATH=src python scripts/torch_fuzz_repro.py --seed 12345 --rewrite-matrix
    PYTHONPATH=src python scripts/torch_fuzz_repro.py --cases 200 --base-seed 0
    PYTHONPATH=src python scripts/torch_fuzz_repro.py --seed 12345 --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _describe(case) -> str:
    q = case.query
    lines = [f"seed {case.seed}: fact rows={int(case.tables[q.fact].nvalid)}"
             f" preds={list(q.fact_preds)}"]
    for a in q.arms:
        lines.append(f"  arm {a.table} fk={a.fk_col} "
                     f"feats={list(a.feature_cols)} preds={list(a.preds)}")
        for lk in a.links:
            lines.append(f"    link {lk.table} parent={lk.parent or '<prev>'}"
                         f" fk={lk.fk_col} feats={list(lk.feature_cols)}"
                         f" preds={list(lk.preds)}")
    lines.append(f"  model={type(q.model).__name__ if q.model else None}"
                 f" group_keys={[(g.table, g.col) for g in q.group_keys]}"
                 f" aggs={[(a.op, a.name) for a in q.aggregates]}")
    return "\n".join(lines)


def launches() -> dict:
    """Kernel launches counted by the port's wrappers, by kernel."""
    from repro_torch.kernels import (fused_star_gather, onehot_matmul,
                                     tree_predict)
    return {"fused_star_gather": fused_star_gather.launches,
            "tree_predict": tree_predict.launches,
            "onehot_matmul": onehot_matmul.launches}


def _report(bad, ok_line: str, dt: float) -> int:
    if bad:
        print(f"FAIL ({len(bad)} mismatches, {dt:.1f}s):")
        for b in bad:
            print(" ", b)
        return 1
    print(f"{ok_line} ({dt:.1f}s)")
    return 0


def _rewrite_matrix(seed: int, device) -> int:
    from repro_torch.core.query import compile_query, rewrite_query
    from repro_torch.core.query.workload import (_compare, generate_case,
                                                 np_oracle)
    case = generate_case(seed, device=device)
    print(_describe(case))
    rw = rewrite_query(case.tables, case.query)
    print("rewrite trail:", list(rw.trail) or "(nothing fired)")
    want = np_oracle(case.tables, case.query)
    bad = []
    t0 = time.time()
    for backend in ("fused", "nonfused"):
        for agg_backend in ("segment", "matmul"):
            for mode in ("on", "off"):
                plan = compile_query(case.catalog(), case.query,
                                     backend=backend,
                                     agg_backend=agg_backend, rewrite=mode)
                bad += _compare(plan.run(), want, case.query,
                                f"seed={seed} {backend}/{agg_backend}/"
                                f"rewrite={mode}")
    return _report(bad, f"OK: seed {seed} rewrite on == off == oracle "
                        f"across all combos", time.time() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--seed", type=int, help="replay one case by seed")
    mode.add_argument("--cases", type=int, help="run a K-case campaign")
    ap.add_argument("--base-seed", type=int, default=0,
                    help="campaign base seed (case i uses base*10000+i)")
    ap.add_argument("--full-every", type=int, default=4,
                    help="full-matrix check every Nth campaign case")
    ap.add_argument("--rewrite-matrix", action="store_true",
                    help="with --seed: compare rewrite on vs off across "
                         "every backend combo (and both vs the oracle)")
    ap.add_argument("--device", default="cuda",
                    help="where the tables live and the plans run "
                         "(default cuda; cpu to run on the CPU)")
    args = ap.parse_args(argv)
    if args.rewrite_matrix and args.seed is None:
        ap.error("--rewrite-matrix requires --seed")

    from repro_torch.device import resolve_device
    from repro_torch.core.query.workload import (check_case, check_kernels,
                                                 generate_case, run_fuzz)
    device = resolve_device(None if args.device == "cuda" else args.device)

    if args.rewrite_matrix:
        rc = _rewrite_matrix(args.seed, device)
    elif args.seed is not None:
        print(_describe(generate_case(args.seed, device=device)))
        t0 = time.time()
        bad = check_case(args.seed, full=True, device=device)
        bad += check_kernels(args.seed, device=device)
        rc = _report(bad, f"OK: seed {args.seed} bit-exact across the full "
                          f"matrix", time.time() - t0)
    else:
        t0 = time.time()
        rep = run_fuzz(args.cases, seed=args.base_seed,
                       full_every=args.full_every, device=device)
        print(f"{rep.summary()} ({time.time() - t0:.1f}s)")
        for b in rep.failures:
            print(" ", b)
        t0 = time.time()
        bad = [b for s in rep.seeds for b in check_kernels(s, device=device)]
        rc = max(_report(bad, f"kernel leg: {len(rep.seeds)} cases, 0 "
                              f"mismatches", time.time() - t0),
                 0 if rep.ok else 1)
    if device.type == "cuda":
        import torch
        print(f"[peak_bytes] {torch.cuda.max_memory_allocated(device)}")
    print("[launches]", json.dumps(launches()), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
