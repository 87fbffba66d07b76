#!/usr/bin/env python
"""Memory-cap proof on the port (the port of ``scripts/memcap_proof.py``):
under a memory cap that holds the streamed program, the in-core program
runs out of memory and the streamed one completes.

Both modes build the same synthetic star as the reference's (the resident
catalog tables are a shared cost); the difference is the online program.
In core, one program runs over the whole fact axis and materializes
per-row intermediates — gathered arm partials, the (rows, 32) prediction
matrix, validity and group vectors — for every row at once.  Streaming
folds the same program chunk by chunk through a carried segment
accumulator, so its intermediates are one chunk's, not the table's.

Where the data lives sets the cap:

* On the card (``--device cuda``, the default; with no card it raises):
  the tables live in device memory and each child caps its own device
  memory with ``torch.cuda.set_per_process_memory_fraction(cap / total)``
  before its first allocation.  ``--mode both`` runs each mode uncapped
  (their peaks, ``torch.cuda.max_memory_allocated``, must straddle the
  cap, or the proof would be vacuous) and, at the same time, each mode
  under ``--cap-gb``:
  the streamed child must complete with outputs equal bit for bit to the
  uncapped streamed child's (``digest``), and the in-core child must raise
  ``torch.OutOfMemoryError``, which it catches, reports on a
  ``[memcap] incore OOM`` line and turns into exit code ``OOM_EXIT``.  Any
  other exit fails the proof.  The streamed children run with torch's
  deterministic algorithms on, so their float group sums (an
  ``index_add_``, with atomics otherwise) are the same in every run; that
  path holds more memory and takes about 19 s more on an H100 at 60M rows.
  The in-core children run the default path, whose peak is the one the
  cap must lie under.
* On the CPU (``--device cpu``): the reference's form — each mode runs in
  a child under ``RLIMIT_AS = --cap-mb``; the streamed child must
  complete and the in-core child must die.

``--mode stream`` / ``--mode incore`` run one program in this process
(under ``--cap-gb`` on the card when given) and exit 0 on success.  Every
child prints its checksum (the reference's: the float64 sum of the
``pred`` group sums), a digest of all its outputs, its peak and, last, its
kernel launches as JSON after ``[launches]`` (on the card the fused plans
run ``fused_star_gather``).  ``--mode both`` ends with one ``[memcap]``
JSON line (the cap, each child's exit code, seconds and peak) and the
launches of all its children.

Usage:  PYTHONPATH=src python scripts/torch_memcap_proof.py [--cap-gb 8]
        [--rows 60000000] [--budget-mb 64]
        PYTHONPATH=src python scripts/torch_memcap_proof.py --device cpu
        [--cap-mb 2000] [--rows 3000000]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import resource
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

#: Rows of the fact on the card: SF 10's lineorder (about 1.4 GB of fact);
#: at l = 32 the in-core prediction matrix alone is 7.7 GB.
CARD_ROWS = 60_000_000
#: Device-memory cap on the card, between the two modes' uncapped peaks.
CARD_CAP_GB = 8.0
#: Rows and address-space cap on the CPU: the reference's cap, and rows
#: whose streamed child fits it beside torch's own address space.
CPU_ROWS = 3_000_000
CPU_CAP_MB = 2000
#: Exit code of an in-core child that ran out of memory.
OOM_EXIT = 3
OOM_MARK = "[memcap] incore OOM"


def build_catalog(rows: int, device):
    """A 2-arm star whose fact dominates memory: ``rows`` x 6 columns, the
    reference's numbers in the reference's order."""
    import numpy as np

    from repro_torch.core.laq import Catalog, Table

    rng = np.random.default_rng(0)
    n_dim = 1024
    d1 = {"pk": np.arange(n_dim) * 2,
          "a": rng.normal(size=n_dim), "b": rng.normal(size=n_dim)}
    d2 = {"pk2": np.arange(n_dim),
          "c": rng.normal(size=n_dim),
          "g": rng.integers(0, 8, n_dim)}
    f = {"fk1": rng.integers(0, 2 * n_dim, rows),
         "fk2": rng.integers(0, n_dim, rows),
         "v0": rng.normal(size=rows).astype(np.float32),
         "v1": rng.normal(size=rows).astype(np.float32),
         "v2": rng.normal(size=rows).astype(np.float32),
         "v3": rng.normal(size=rows).astype(np.float32)}
    return Catalog({
        "d1": Table.from_columns("d1", d1, key_cols=("pk",), device=device),
        "d2": Table.from_columns("d2", d2, key_cols=("pk2", "g"),
                                 device=device),
        "fact": Table.from_columns("fact", f, key_cols=("fk1", "fk2"),
                                   device=device),
    })


def the_query():
    """The reference's query: a wide linear head (l = 32), whose (rows, 32)
    prediction matrix the in-core program materializes and the streamed
    one holds a chunk of."""
    import numpy as np
    import torch

    from repro_torch.core.fusion import LinearOperator
    from repro_torch.core.laq.selection import Pred
    from repro_torch.core.query import (PREDICTION, Aggregate, ArmSpec,
                                        GroupKey, PredictiveQuery)

    model = LinearOperator(torch.from_numpy(
        np.random.default_rng(1).normal(size=(3, 32)).astype(np.float32)))
    return PredictiveQuery(
        fact="fact",
        arms=(ArmSpec("d1", "fk1", "pk", ("a", "b"),
                      (Pred("a", ">", -1.0),)),
              ArmSpec("d2", "fk2", "pk2", ("c",))),
        fact_preds=(Pred("v0", ">", -2.0),),
        model=model,
        group_keys=(GroupKey("d2", "g", 8),),
        aggregates=(Aggregate(PREDICTION, "sum", "pred"),
                    Aggregate("v1", "mean", "m1"),
                    Aggregate(("mul", "v2", "v3"), "sum", "x23"),
                    Aggregate("*", "count", "n")),
        num_groups=8)


def launches() -> dict:
    from repro_torch.kernels import (fused_star_gather, onehot_matmul,
                                     tree_predict)
    return {"fused_star_gather": fused_star_gather.launches,
            "tree_predict": tree_predict.launches,
            "onehot_matmul": onehot_matmul.launches}


def cap_device_memory(cap_gb: float, device) -> None:
    """Cap this process's device memory at ``cap_gb`` GB (before its first
    allocation); the cap acts on this process alone."""
    import torch
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    total = torch.cuda.get_device_properties(index).total_memory
    torch.cuda.set_per_process_memory_fraction(
        min(1.0, cap_gb * 1e9 / total), index)


def run_mode(mode: str, rows: int, budget_mb: int, device="cpu") -> dict:
    """Build the star on ``device`` and run ``mode``'s program: ``stream``
    under a ``budget_mb`` memory budget (which must pick streaming),
    ``incore`` pinned to fused/gather/segment.  Prints and returns the
    checksum, the digest of every output, the row count and, on the card,
    the peak."""
    import numpy as np
    import torch

    from repro_torch.core.query import compile_query

    on_card = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    cat = build_catalog(rows, device)
    q = the_query()
    t1 = time.perf_counter()
    if mode == "stream":
        plan = compile_query(cat, q,
                             memory_budget_bytes=budget_mb * 1024 * 1024)
        if plan._stream is None:
            raise RuntimeError("the budget did not trigger streaming")
        print(f"[memcap] stream: {plan._stream.describe()}", flush=True)
    else:
        plan = compile_query(cat, q, backend="fused",
                             join_backend="gather", agg_backend="segment")
    t2 = time.perf_counter()
    out = {k: v.cpu().numpy() for k, v in plan.run().items()}
    t3 = time.perf_counter()
    digest = hashlib.sha256()
    for k in sorted(out):
        digest.update(k.encode() + np.ascontiguousarray(out[k]).tobytes())
    res = dict(mode=mode, rows=rows,
               checksum=float(np.sum(np.asarray(out["pred"], np.float64))),
               n=int(np.asarray(out["n"]).sum()), digest=digest.hexdigest(),
               build_s=t1 - t0, compile_s=t2 - t1, run_s=t3 - t2,
               peak_bytes=torch.cuda.max_memory_allocated() if on_card
               else None)
    print(f"[memcap] {mode} ok: checksum {res['checksum']:.6e} "
          f"n={res['n']}", flush=True)
    print(f"[memcap] {mode} result {json.dumps(res)}", flush=True)
    return res


def child(args) -> int:
    """One mode in this process (``--mode stream`` / ``incore``)."""
    import torch
    from repro_torch.device import resolve_device
    device = resolve_device(None if args.device == "cuda" else args.device)
    if device.type == "cuda":
        if args.mode == "stream":
            torch.use_deterministic_algorithms(True)
        if args.cap_gb is not None:
            cap_device_memory(args.cap_gb, device)
    try:
        run_mode(args.mode, args.rows, args.budget_mb, device)
    except torch.OutOfMemoryError as e:
        if args.mode != "incore":
            raise
        print(f"{OOM_MARK}: {type(e).__name__}: "
              f"{str(e).splitlines()[0][:160]}", flush=True)
        print("[launches]", json.dumps(launches()), flush=True)
        return OOM_EXIT
    print("[launches]", json.dumps(launches()), flush=True)
    return 0


def _spawn(mode: str, args, cap=None) -> dict:
    """``mode`` in a child process of its own, from the repository root:
    under ``--cap-gb cap`` on the card, under ``RLIMIT_AS = cap`` MB on
    the CPU, uncapped when ``cap`` is None.  Returns its exit code,
    seconds, result and launches."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    cmd = [sys.executable, str(Path(__file__).resolve()), "--mode", mode,
           "--rows", str(args.rows), "--budget-mb", str(args.budget_mb),
           "--device", args.device]
    limit = None
    if cap is not None and args.device == "cpu":
        def limit():
            resource.setrlimit(resource.RLIMIT_AS,
                               (cap * 1024 * 1024, cap * 1024 * 1024))
    elif cap is not None:
        cmd += ["--cap-gb", str(cap)]
    t = time.perf_counter()
    proc = subprocess.run(cmd, preexec_fn=limit, env=env, cwd=root,
                          capture_output=True, text=True)
    out = dict(mode=mode, cap=cap, returncode=proc.returncode,
               seconds=time.perf_counter() - t, result=None, launches=None,
               oom=False, stdout=proc.stdout, stderr=proc.stderr)
    for line in proc.stdout.splitlines():
        if line.startswith(f"[memcap] {mode} result "):
            out["result"] = json.loads(line.split(" result ", 1)[1])
        elif line.startswith("[launches] "):
            out["launches"] = json.loads(line.split(" ", 1)[1])
        elif line.startswith(OOM_MARK):
            out["oom"] = True
    return out


def _spawn_all(args, caps):
    """Both modes under each cap of ``caps``, every child at once."""
    runs = [(m, c) for c in caps for m in ("stream", "incore")]
    with ThreadPoolExecutor(len(runs)) as pool:
        return list(pool.map(lambda r: _spawn(r[0], args, r[1]), runs))


def both(args) -> int:
    """The proof: every mode in a child process (module docstring)."""
    on_card = args.device == "cuda"
    if on_card:
        from repro_torch.device import resolve_device
        resolve_device(None)          # raises with no card
    cap = args.cap_gb if on_card else args.cap_mb
    unit = "GB" if on_card else "MB"
    bad = []
    if on_card:
        # Uncapped and capped at once: the uncapped peaks are checked
        # against the cap once every child has ended.
        children = _spawn_all(args, (None, cap))
        free, (s, i) = children[:2], children[2:]
    else:
        children = _spawn_all(args, (cap,))
        free, (s, i) = (None, None), children
    if on_card:
        for c in free:
            if c["returncode"] != 0 or c["result"] is None:
                bad.append(f"uncapped {c['mode']} failed "
                           f"(rc={c['returncode']})\n{c['stderr'][-2000:]}")
        if not bad:
            sp, ip = (c["result"]["peak_bytes"] for c in free)
            print(f"[memcap] uncapped peaks: stream {sp / 1e9:.3f} GB, "
                  f"in-core {ip / 1e9:.3f} GB; cap {cap} GB", flush=True)
            if not sp < cap * 1e9 < ip:
                bad.append(f"the cap {cap} GB does not lie between the "
                           f"uncapped peaks ({sp} and {ip} bytes): the "
                           f"proof would be vacuous")
    print(s["stdout"], end="", flush=True)
    if s["returncode"] != 0 or s["result"] is None:
        bad.append(f"streaming died under the {cap} {unit} cap "
                   f"(rc={s['returncode']})\n{s['stderr'][-2000:]}")
    elif on_card and free[0]["result"] is not None and s["result"][
            "digest"] != free[0]["result"]["digest"]:
        bad.append("the capped streamed outputs differ from the uncapped "
                   f"ones: {s['result']} vs {free[0]['result']}")
    if on_card and not (i["returncode"] == OOM_EXIT and i["oom"]):
        bad.append(f"in-core did not raise torch.OutOfMemoryError under "
                   f"the {cap} GB cap (rc={i['returncode']})\n"
                   f"{i['stdout'][-1000:]}{i['stderr'][-2000:]}")
    elif not on_card and i["returncode"] == 0:
        bad.append(f"in-core survived the {cap} MB cap — raise --rows "
                   "or lower --cap-mb so the proof is non-vacuous")
    else:
        last = [ln for ln in (i["stdout"] + i["stderr"]).splitlines()
                if ln.strip()]
        print(f"[memcap] in-core OOMs as expected (rc={i['returncode']}"
              f"): {last[-1][:160] if last else 'killed'}", flush=True)
    total = {}
    for c in children:
        for k, v in (c["launches"] or {}).items():
            total[k] = total.get(k, 0) + v
    print("[memcap]", json.dumps(dict(
        device=args.device, rows=args.rows, budget_mb=args.budget_mb,
        cap=cap, cap_unit=unit,
        uncapped_peak_bytes={c["mode"]: (c["result"] or {}).get("peak_bytes")
                             for c in children if c["cap"] is None} or None,
        children=[dict(mode=c["mode"], cap=c["cap"],
                       returncode=c["returncode"], seconds=c["seconds"],
                       oom=c["oom"],
                       peak_bytes=(c["result"] or {}).get("peak_bytes"),
                       build_s=(c["result"] or {}).get("build_s"),
                       run_s=(c["result"] or {}).get("run_s"),
                       checksum=(c["result"] or {}).get("checksum"),
                       digest=(c["result"] or {}).get("digest"))
                  for c in children], ok=not bad)), flush=True)
    for b in bad:
        print(f"[memcap] FAIL: {b}", flush=True)
    if not bad:
        print(f"[memcap] PROOF OK: cap={cap}{unit} rows={args.rows} — "
              "in-core OOMs, streaming completes", flush=True)
    print("[launches]", json.dumps(total), flush=True)
    return 0 if not bad else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("both", "stream", "incore"),
                    default="both")
    ap.add_argument("--device", default="cuda",
                    help="where the tables live (default cuda; cpu for the "
                         "reference's RLIMIT_AS form)")
    ap.add_argument("--rows", type=int, default=None,
                    help=f"fact rows (default {CARD_ROWS} on the card, "
                         f"{CPU_ROWS} on the CPU)")
    ap.add_argument("--budget-mb", type=int, default=64)
    ap.add_argument("--cap-gb", type=float, default=None,
                    help="device-memory cap on the card (default "
                         f"{CARD_CAP_GB} with --mode both)")
    ap.add_argument("--cap-mb", type=int, default=CPU_CAP_MB,
                    help="RLIMIT_AS of --mode both's children on the CPU")
    args = ap.parse_args(argv)
    if args.rows is None:
        args.rows = CARD_ROWS if args.device == "cuda" else CPU_ROWS
    if args.mode != "both":
        return child(args)
    if args.cap_gb is None:
        args.cap_gb = CARD_CAP_GB
    return both(args)


if __name__ == "__main__":
    sys.exit(main())
