#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root, one card

Phases, each printing one JSON object per line (any failure raises and the
script exits non-zero, printing no final result):

  1. device + build — needs CUDA and compute capability 9.0; prints the
     card's name and power limit as ``nvidia-smi`` gives them; builds the
     kernels from ``src/repro_torch/kernels/csrc`` with ``nvcc``.
  2. kernels vs plain versions on the card — edge shapes (for
     ``fused_star_gather`` l from 1 to 2048, J up to 8, an unaligned
     partial; for ``tree_predict`` depths 1 to 13, non-finite features at a
     node's column and elsewhere, a +Inf threshold, columns of F that are
     not one-hot, H with NaN, 0.5 or ±Inf), then the paper's widest models
     at ``data/synthetic.py`` sizes (Table 4, scale 1.0).  Equality is exact
     (NaN equal to NaN in the same places); each ``tree_predict`` case
     prints the score path its launch took (tensor cores, or fp32 for an H
     outside {-1, 0, 1}) and must take the expected one.
  3. small check — every registry query at SSB ``scale=0.0005`` on the card
     against the same query on the CPU (the plain path the CPU tests hold
     against the JAX package).
  4. main path — SSB at SF 10 (60M lineorder rows) on the card: every
     registry query compiled with the planner's choices and run; P1–P4 with
     ``backend`` fused and nonfused under ``serve_backend="kernel"`` held
     against the same plan under ``"torch"`` (the nonfused trees' scores
     must run on tensor cores).  The kernels' launch counters are zeroed
     just before and read just after; both must have launched.
  5. serving — ``compile_serving`` over the same SF 10 tables (P1–P4) and
     over the paper's setting 1 (linear l=128 and a depth-7 tree), fused
     and nonfused, under ``"kernel"`` and ``"torch"``: about 200 ragged
     batches each, ``"kernel"`` equal to ``"torch"``, ``serve`` equal to
     ``predict_rows``; one latency line per runtime.  The counters are
     zeroed just before and read just after; both kernels must launch.
  6. sharding — the serving state over virtual meshes of 8 positions on
     the card (every position ``cuda:0``, so the shards run one after
     another there): P1 (fused) and P3 (nonfused tree) on meshes (1,8),
     (2,4) and (8,1), at the planner's ``SHARD_PARTIAL_BYTES`` and at 0;
     each sharded runtime's ``serve`` over ragged traffic equal to the
     single-device ``"torch"`` runtime bit for bit, each sharded plan's
     ``predict_rows`` (4096 ids, 8 outside the fact) equal to the
     single-device plan's and to ``serve`` of its rows; placements,
     ``nbytes_per_device()`` beside the single-device bytes, per-bucket
     p50/p99 beside the single-device runtime's.  Then 3 × 800 part rows
     are appended (into 8,000 spare slots), each append followed by the
     delta refresh of sharded P1/P3 runtimes and plans on (2,4), which
     index again only the shard block that owns the new rows; the
     refreshed objects must equal a cold sharded compile and a cold
     single-device one.  No kernel may launch (the reference's mesh path
     runs none): the counters are zeroed before and must read 0.
  7. ``onehot_matmul``, which no query path calls, against its plain
     version: the reference's test and bench shapes, edge cases
     (non-finite tables, non-finite entries in the first, a middle and the
     last row slab, a NaN no row selects, an all-NaN column, r = 0 and 1,
     d = 1, bf16 with d % 8 != 0, indices out of range, n·d above 2**31)
     and the SF 10 ``lineorder`` supplier positions into ``supplier``.
     Each launch reports its path (the plain gather, or the NaN rule) and
     must take the one its table calls for.
  8. lifecycle — a versioned catalog at SSB SF 10 with 1.12× capacity
     (``ssb_catalog``): appends of 0.1, 1 and 10 % of part, 0.1 % of
     lineorder, an update of a part feature column, deletions from part and
     lineorder, compaction of part and an append past part's capacity.
     After each step P1 (fused) and P3 (nonfused tree), as compiled queries
     and as serving runtimes under ``"kernel"``, refresh; each is held
     against a cold compile on the same catalog (``predictions``,
     ``predict_rows``, ``serve`` and the prefused partials exact, ``run()``
     exact on integer data and rtol 1e-5 on float sums), its decision line
     against the reference's route, and each kernel against its plain
     version on the refreshed state.  ``refresh_ms`` is printed beside
     ``cold_compile_ms``.  The counters are zeroed just before and read
     just after; both kernels must launch.
  9. multi-query work through ``Session`` on a versioned SF 10 catalog
     with 1.12× capacity:
     ``multiquery_registry`` — ``run_all`` over all 16 registry queries
     (pooled artifacts, stacked classes) against unpooled plans with the
     same backends, with the pool's counters and the pooled/unpooled
     artifact bytes; ``multiquery_stacked`` — a 3-member fused P1 class
     and a 3-member nonfused P3 class (one order-date span each) under
     ``"kernel"``: each class's kernel launches once per ``run_all``, and
     against its plain version on the class's state; results against each
     member's ``run()``, unpooled kernel plans and ``"torch"`` plans;
     ``multiquery_refresh`` — an append to ``part`` through the session:
     every pooled refresh's decision line against the reference's, each
     object against a cold compile, pooled against unpooled refresh time;
     ``multiquery_scheduler`` — P1 and P3 runtimes on the session's
     admission scheduler, 4 threads of interactive and batch traffic (each
     result bit for bit the synchronous ``serve`` of the same generation),
     then a fenced refresh under a batch request in flight (its result is
     one generation's, whole).  The counters are zeroed just before the
     four phases and read just after; both kernels must launch.
 10. snowflake — ``benchmarks/bench_snowflake.py``'s schema (copied) at
     scale 60: 60M ``sales`` rows → 1.2M customers → 256 nations → 32
     regions, features on every hop, a predicate two hops deep.  First the
     same query at scale 0.0005 on the card against the CPU; then per
     ``chain_strategy`` (through, materialize, auto) the collapse time, and
     per strategy and backend a plan whose ``run()`` equals the flat
     ``materialize_chains`` plan bit for bit; a depth-3 tree over the
     chained features (``"kernel"`` against ``"torch"``, each kernel
     against its plain version); a nation append through a ``Session``
     (refresh against a cold compile, with ``refresh_ms`` beside
     ``cold_compile_ms``); serving runtimes over the chain, ``serve`` equal
     to ``predict_rows``.
 11. rewrite — ``benchmarks/bench_rewrite.py``'s schema (copied) at scale
     8: 8M fact rows, K=16, a depth-7 tree (p=127, l=128) filtered on its
     last leaf.  The distilled ``"on"`` plan (no model) against ``"off"``
     plans under fused and nonfused ``"kernel"`` in ``run()`` and after
     each of 3 append → ``refresh()`` cycles, bit for bit; the rewrite
     pass, run and refresh times; a linear query whose feature an equality
     pins, folded into the bias through ``fused_star_gather``.
 12. fuzz — the port's ``check_case`` (the full matrix, its 16-row
     streaming leg included) on the card for 24 flat and 24 chained seeds,
     plus ``"kernel"`` plans and runtimes against the numpy oracles, bit
     for bit.  Phases 10–12 each zero the counters just before and read them
     just after; both kernels must launch in each.
 13. streaming — the fact axis out of core on a versioned SF 10 catalog
     with 1.12× capacity: P1 (linear), P3 (tree) and Q2.1 (no model, with
     count, min and max added to its revenue sum) each under a
     ``memory_budget_bytes`` that cuts the fact into ``STREAM_CHUNKS``
     chunks, and P1 again at a pinned chunk size that divides nothing,
     each against the in-core run pinned to fused/gather/segment (rows,
     groups, counts, min, max and the tree's sums exact; float sums at
     rtol 1e-5, or ``2·sqrt(n)·2**-24`` where a group folds n rows and that
     is larger (``fold_rtol``), with each float sum's error against a
     float64 sum printed);
     ``fused_star_gather`` must launch once per chunk of every model run.
     Then 0.1 % of lineorder is appended and the streamed P1 refreshes in
     place (no rebuilt chunk buffers, the same pinned host buffers) and is
     held against a cold streamed compile.  ``run_ms`` streamed and in
     core, the chunks, and the copy time of one chunk are printed.  The
     counters are zeroed just before and read just after.
 14. LM serving — ``launch/serve.py`` on the card: smollm-360m at its full
     config (32 layers, d_model 960, 15 heads over 5 KV heads, vocab
     49152, bf16; parameters from ``LM.init`` with a seeded generator)
     behind ``FusedFeatureServer`` at the paper's setting 1, SF 10 (6M
     fact rows, k=64, a linear head with l=8).  The fused runtime must
     serve on ``"kernel"`` and equal the same session's ``"torch"``
     runtime bit for bit over one ragged sweep of every bucket.  Then
     ``decode_batch`` (the per-batch body of ``run_serving``) at batch 4
     and 32, 8 decode steps, 10 repeats, fused and non-fused: the tokens
     must be equal in every repeat (on a difference the top-two logit gap
     at that row is printed); p50/p99 per batch (repeats after the first
     two) and per bucket.  ``run_serving("smollm-360m", batch=4,
     decode_steps=8, k=96, l=8, repeats=3)`` runs once as written.  The
     same weights decoded in bf16 and in fp32 (largest |Δlogit|, share of
     equal argmaxes), and the fp32 decode chain held to the fp32 forward
     (``LM_FP32_ATOL``); PyTorch's default
     ``allow_bf16_reduced_precision_reduction`` is kept and printed.  The
     first request of each batch size is decoded a second time, fused: its
     logits must equal the first decode's bit for bit.  The host time of
     one decode step is printed per batch, and the peak device memory.
     The counters are zeroed after the sweep and read after
     ``run_serving``; ``fused_star_gather`` must launch exactly once per
     fused serve (each batch fits a bucket).
 15. LM serving of the MoE and recurrent archs — phase 14 again (the
     bf16-against-fp32 lines aside) for qwen2-moe-a2.7b at its full config
     (24 layers, d_model 2048, 60 experts top-4 with a 5632-wide shared
     MLP, vocab 151936, bf16: 14.3B parameters, 28.6 GB), 8 repeats, and
     for xlstm-125m at its full config (12 mLSTM/sLSTM layers, d_model
     768), 4 repeats; ``run_serving`` of each arch's smoke config.
 16. LM archs — the MoE, Mamba and xLSTM archs (qwen2-moe-a2.7b,
     dbrx-132b, jamba-1.5-large-398b, xlstm-125m) in fp32: each smoke
     config's ``forward`` on the card against the same parameters on the
     CPU (``LM_CARD_CPU_ATOL``, logits and MoE aux loss) and its decode
     chain against its forward (``LM_FP32_ATOL``); qwen2-moe-a2.7b at full
     width cut to 2 layers, and xlstm-125m at full width, decode chain
     against forward (8 tokens: no MoE pair is dropped).  dbrx-132b (263
     GB in bf16) and jamba-1.5-large-398b (797 GB) do not fit one card and
     run at their smoke configs only; a line says so.  No kernel may
     launch.
 17. the kernels line (timed at the main path's shapes, and
     ``onehot_matmul`` at the SF 10 shape; launches per phase), then the
     device line.

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
BF16_TENSOR_FLOPS_PER_S = 989e12      # dense, on tensor cores

SF = 10                       # main path scale factor (60M fact rows)
ROW_BATCH = 4096              # predict_rows batch on the main path
LINEAR_AGG_RTOL = 1e-5        # index_add_ on CUDA sums with atomics
SERVE_SIZES = (1, 8, 9, 64, 65, 512, 2048)   # buckets 8/64/512, edges, chunks
SERVE_BATCHES = 196           # 28 rounds of SERVE_SIZES
SERVE_CHECK_ROWS = 512        # serve vs predict_rows batch (the top bucket)
LINEAR_SERVE_RTOL = 1e-6      # nonfused linear heads: 1 ulp
CHECK_CHUNK = 1 << 27         # elements compared at a time
ONEHOT_BIG_ROWS = (1 << 29) + 3   # n·d above 2**31 at d = 4 and 5
CALLS = 100                   # calls per device_ms / host_us reading
HOLD_CYCLES = 50_000_000      # sleep that holds the stream (~25 ms)


def emit(**obj):
    print(json.dumps(obj), flush=True)


def same(a, b) -> bool:
    """Exact equality with NaN equal to NaN in the same places."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    a, b = a.reshape(-1), b.reshape(-1)
    for i in range(0, a.numel(), CHECK_CHUNK):
        x, y = a[i:i + CHECK_CHUNK], b[i:i + CHECK_CHUNK]
        if not bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all()):
            return False
    return True


def max_abs_err(a, b) -> float:
    import torch
    a, b = a.reshape(-1), b.reshape(-1)
    worst = 0.0
    for i in range(0, a.numel(), CHECK_CHUNK):
        x, y = a[i:i + CHECK_CHUNK], b[i:i + CHECK_CHUNK]
        fin = torch.isfinite(x) & torch.isfinite(y)
        if bool(fin.any()):
            worst = max(worst, float((x[fin] - y[fin]).abs().max()))
    return worst


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


def device_ms(fn, calls: int = CALLS) -> float:
    """Device time of one call: CUDA events around ``calls`` back-to-back
    calls, over ``calls``.  A sleep kernel holds the stream while the host
    enqueues them, so they run back to back on the card whatever the host's
    own time per call (checked: the enqueueing must end inside the sleep)."""
    import torch
    fn()
    torch.cuda.synchronize()
    held = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    held.record()
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    stop.record()
    stop.synchronize()
    if enqueue_ms >= held.elapsed_time(start):
        raise AssertionError(f"device_ms: enqueueing took {enqueue_ms} ms, "
                             f"longer than the sleep that held the stream")
    return start.elapsed_time(stop) / calls


def host_us(fn, calls: int = CALLS) -> float:
    """Host time of one call in microseconds: ``calls`` calls with no
    synchronize between them, on the host clock, over ``calls``."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


# ------------------------------------------------------------- yardsticks
def gather_bytes_ops(ptrs, tables, h):
    """fused_star_gather: each input read once, the output written once."""
    J, n = ptrs.shape
    l = tables[0].shape[1]
    nbytes = J * n * 4 + J * n + sum(t.numel() * 4 for t in tables)
    nbytes += (l * 4 if h is not None else 0) + n * l * 4
    return nbytes, n * l * J


def tree_bytes_ops(x, F, H):
    """tree_predict: the work the function needs, as (bytes, fp32
    operations, score operations).  F's columns are one-hot, so a predicate
    is one gather per (row, node) plus one finiteness test per feature
    (n·(p+k), fp32 units); the scores are a (n, p)·(p, l) product,
    2·n·p·l operations, exact in bf16 when H is in {-1, 0, 1}."""
    n, k = x.shape
    p, l = H.shape
    nbytes = (n * k + k * p + p + p * l + l + n * l) * 4
    return nbytes, n * (p + k), 2 * n * p * l


def bound(nbytes, ops, tensor_ops=0):
    """(bound_ms, bound_by, bound_rate): the least time the card could take,
    the largest of the bytes over the HBM rate, the fp32 operations over the
    fp32 rate and the tensor-core operations over the bf16 dense rate."""
    times = [(nbytes / HBM_BYTES_PER_S * 1e3, "bytes", "HBM 3.35 TB/s"),
             (ops / FP32_FLOPS_PER_S * 1e3, "operations", "fp32 67 TFLOP/s"),
             (tensor_ops / BF16_TENSOR_FLOPS_PER_S * 1e3, "operations",
              "bf16 tensor cores 989 TFLOP/s")]
    return max(times, key=lambda t: t[0])


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
    return smi


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
    row["shape"] = {k: row[k] for k in ("J", "n", "l")}
    if timing:
        nbytes, ops = gather_bytes_ops(ptrs, tables, h)
        row.update(
            bytes=nbytes, operations=ops,
            kernel_ms=time_ms(lambda: fused_star_gather(ptrs, founds, tables,
                                                        h)),
            plain_ms=time_ms(lambda: fused_star_gather_ref(ptrs, founds,
                                                           tables, h)),
            library_ms=(time_ms(embedding_bag_call(ptrs, founds, tables))
                        if library else None),
            launches=fused_star_gather.launches)
        row["bound_ms"], row["bound_by"], row["bound_rate"] = bound(nbytes,
                                                                   ops)
    emit(**row)
    return row


def tree_score_path():
    """Which score stage the last ``tree_predict`` launch took, read back
    from the kernel's flags (waits for the card): ``"tensor cores"`` or
    ``"fp32"``, and how many columns of F took the fp32 dot."""
    from repro_torch.kernels import tree_predict
    bad_h, dot_nodes = tree_predict.last_flags.tolist()
    return ("fp32" if bad_h else "tensor cores"), dot_nodes


def check_tree(label, x, tree, timing=False, expect_path=None):
    """Kernel vs plain version, exactly; ``tree`` is anything with F, v, H
    and h.  A launch reports its score path; with ``expect_path`` it must
    be that one."""
    from repro_torch.kernels import tree_predict, tree_predict_ref
    import torch
    args = (x, tree.F, tree.v, tree.H, tree.h)
    before = tree_predict.launches
    got = tree_predict(*args)
    path, dot_nodes = (tree_score_path() if tree_predict.launches > before
                       else (None, None))
    if expect_path is not None and path != expect_path:
        raise AssertionError(f"tree_predict {label}: scores ran on {path}, "
                             f"expected {expect_path}")
    want = tree_predict_ref(*args)
    torch.cuda.synchronize()
    if not same(got, want):
        raise AssertionError(f"tree_predict {label}: kernel != plain "
                             f"(max abs err {max_abs_err(got, want)})")
    p, l = tree.H.shape
    row = dict(phase="kernel", kernel="tree_predict", case=label,
               n=int(x.shape[0]), k=int(x.shape[1]), p=int(p), l=int(l),
               equal=True, max_abs_err=max_abs_err(got, want),
               score_path=path, dot_nodes=dot_nodes)
    row["shape"] = {k: row[k] for k in ("n", "k", "p", "l")}
    if timing:
        nbytes, ops, score_ops = tree_bytes_ops(x, tree.F, tree.H)
        if path == "fp32":
            ops, score_ops = ops + score_ops, 0
        row.update(bytes=nbytes, operations=ops, tensor_operations=score_ops,
                   kernel_ms=time_ms(lambda: tree_predict(*args)),
                   plain_ms=time_ms(lambda: tree_predict_ref(*args)),
                   library_ms=None, launches=tree_predict.launches)
        row["bound_ms"], row["bound_by"], row["bound_rate"] = bound(
            nbytes, ops, score_ops)
    emit(**row)
    return row


def gather_edge_inputs(rng, dev, n, J, l, unaligned=False):
    """Random partials with a NaN entry (read by rows whose arm misses, so
    NaN·0 must stay NaN), pointers from -2 to r_j + 1 (clipped), about 1 in
    5 misses; with ``unaligned`` the last partial is a contiguous view one
    float into its buffer, so no 16-byte access applies to it."""
    import numpy as np
    import torch
    rows = [int(r) for r in rng.integers(1, 50, size=J)]
    tables = [torch.from_numpy(rng.normal(size=(r, l)).astype(
        np.float32)).to(dev) for r in rows]
    tables[-1][0, 0] = float("nan")
    if unaligned:
        buf = torch.empty(rows[-1] * l + 1, device=dev)
        tables[-1] = buf[1:].view(rows[-1], l)
        tables[-1].copy_(torch.from_numpy(rng.normal(
            size=(rows[-1], l)).astype(np.float32)))
        tables[-1][0, 0] = float("nan")
    ptrs = torch.from_numpy(np.stack(
        [rng.integers(-2, r + 2, size=n) for r in rows]
    ).astype(np.int32)).to(dev)
    founds = torch.from_numpy(rng.random((J, n)) < 0.8).to(dev)
    return ptrs, founds, tables


def tree_edge_variants(tree, x):
    """(label, x, tree) variants of one tree and batch that the predicate
    gather and the tensor-core scores must get right: non-finite features at
    a node's feature and elsewhere in a row, whole non-finite rows, a +Inf
    threshold, columns of F that are not one-hot, and H entries outside
    {-1, 0, 1} (NaN, 0.5, ±Inf), which take the fp32 score path."""
    import types
    import torch
    F, v, H = tree.F.clone(), tree.v.clone(), tree.H.clone()
    k, p = F.shape
    f0 = int(F[:, 0].argmax())                 # node 0's feature
    other = (f0 + 1) % k
    x = x.clone()
    n = x.shape[0]
    marks = [(3, f0, float("nan")), (4, f0, float("inf")),
             (5, f0, -float("inf")), (6, other, float("nan")),
             (7, other, float("inf")), (9, f0, float("inf")),
             (9, other, -float("inf"))]
    for r, c, val in marks:
        if r < n and c < k:
            x[r, c] = val
    if n > 8:
        x[8] = float("nan")

    def variant(**kw):
        return types.SimpleNamespace(
            F=kw.get("F", F), v=kw.get("v", v), H=kw.get("H", H), h=tree.h)
    out = [("non-finite features", x, variant())]
    v_inf = v.clone()
    v_inf[0] = float("inf")
    out.append(("v[0]=+Inf", x, variant(v=v_inf)))
    if p >= 4 and k >= 2:
        F2 = F.clone()
        g1 = int(F2[:, 1].argmax())
        F2[(g1 + 1) % k, 1] = 0.5              # two non-zero entries
        F2[:, 2] = 0.0                         # no entry at all
        F2[:, 3] *= -1.0                       # a -1 where the 1 was
        out.append(("F not one-hot", x, variant(F=F2)))
    for label, vals in (("H NaN", (float("nan"),)), ("H 0.5", (0.5,)),
                        ("H +-Inf", (float("inf"), -float("inf")))):
        H2 = H.clone()
        for i, val in enumerate(vals):
            H2[i % p, (2 * i + 1) % H2.shape[1]] = val
        out.append((label, x, variant(H=H2)))
    return out


def phase_kernel_edges(dev):
    import numpy as np
    import torch
    from repro_torch.core.fusion import random_tree
    rng = np.random.default_rng(0)
    for n in (0, 1, 1000):
        for J in (1, 3, 8):
            for l in (1, 2, 3, 4, 8, 128, 129, 2048):
                ptrs, founds, tables = gather_edge_inputs(rng, dev, n, J, l)
                check_gather(f"edge n={n} J={J} l={l}", ptrs, founds, tables)
                itables = [t.nan_to_num(0.0).round() for t in tables]
                h = torch.from_numpy(rng.integers(-1, 2, size=l).astype(
                    np.float32)).to(dev)
                check_gather(f"edge n={n} J={J} l={l} h", ptrs, founds,
                             itables, h)
    for l in (4, 128):
        ptrs, founds, tables = gather_edge_inputs(rng, dev, 1000, 3, l,
                                                  unaligned=True)
        check_gather(f"edge unaligned partial l={l}", ptrs, founds, tables)
        h = torch.from_numpy(rng.integers(-1, 2, size=l).astype(
            np.float32)).to(dev)
        check_gather(f"edge unaligned partial l={l} h", ptrs, founds,
                     [t.nan_to_num(0.0).round() for t in tables], h)
    # Trees from depth 1 to the depth-13 edge (p=8191, l=8192, in the
    # planner's bounds), whose H streams through shared memory in chunks:
    # the narrow kernel (l <= 16; at k = 512 and 1024 its 128-row tile does
    # not fit and such trees take the general kernel) and the general one at
    # 4, 2 and 1 m-tiles per warp (depth 7; depth 5; k=2000, whose 16-row
    # tile is 128 KB), with
    # swizzled rows (k % 32 == 0) and an x that is not 16-byte aligned.
    for k, depth in ((5, 1), (5, 3), (6, 4), (1024, 3), (512, 4), (5, 5),
                     (128, 7), (1024, 7), (2000, 8), (5, 13)):
        for n in (0, 1, 1000):
            tree = random_tree(rng, k, depth).to(dev)
            x = torch.from_numpy(rng.normal(size=(n, k)).astype(
                np.float32)).to(dev)
            check_tree(f"edge k={k} depth={depth} n={n}", x, tree,
                       expect_path="tensor cores" if n else None)
            if n == 1000:
                for label, xx, t in tree_edge_variants(tree, x):
                    check_tree(f"edge k={k} depth={depth} n={n} {label}",
                               xx, t, expect_path=(
                                   "fp32" if label.startswith("H ")
                                   else "tensor cores"))
            if n == 1000 and k == 128:
                buf = torch.empty(n * k + 1, device=dev)
                xu = buf[1:].view(n, k)
                xu.copy_(x)
                check_tree(f"edge k={k} depth={depth} n={n} unaligned x",
                           xu, tree, expect_path="tensor cores")
    # Trees pruned as the rewrite engine prunes them: decided nodes leave
    # F, v and H and fold into h, so p is no longer 2^d - 1 (l stays).
    for k, depth, drop in ((5, 3, (0, 2)), (6, 4, (1, 4, 9, 13)),
                           (128, 7, tuple(range(0, 127, 3)))):
        tree = pruned_tree(random_tree(rng, k, depth).to(dev), drop)
        for n in (0, 1, 1000, 100_000):
            x = torch.from_numpy(rng.normal(size=(n, k)).astype(
                np.float32)).to(dev)
            check_tree(f"edge pruned k={k} depth={depth} "
                       f"p={tree.H.shape[0]} n={n}", x, tree,
                       expect_path="tensor cores" if n else None)


def pruned_tree(tree, drop):
    """``tree`` without the nodes ``drop``, each decided true: its row of
    H leaves the scores and is taken off ``h`` (``rewrite.py``'s
    ``prune_tree_branches``)."""
    import types
    import torch
    p = tree.H.shape[0]
    keep = torch.tensor([i for i in range(p) if i not in set(drop)],
                        device=tree.H.device)
    h = tree.h - tree.H[list(drop)].sum(0)
    return types.SimpleNamespace(F=tree.F[:, keep].contiguous(),
                                 v=tree.v[keep].contiguous(),
                                 H=tree.H[keep].contiguous(),
                                 h=h.contiguous())


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
                   tree, timing=True, expect_path="tensor cores")
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


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port, by kernel name."""
    from repro_torch.kernels import (fused_star_gather, onehot_matmul,
                                     tree_predict)
    return {"fused_star_gather": fused_star_gather,
            "tree_predict": tree_predict, "onehot_matmul": onehot_matmul}


def reset_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def launches_of(fn) -> dict:
    """Kernel launches one call of ``fn`` makes, by kernel."""
    before = read_launches()
    fn()
    return {k: v - before[k] for k, v in read_launches().items()}


def serve_check_ids(fact, q, rng):
    """``SERVE_CHECK_ROWS`` random fact rows that pass ``q``'s fact-side
    predicates: serving them must reproduce ``predict_rows``.  At the top
    bucket's size both paths run the model on one batch shape."""
    import torch
    ok = fact.valid_mask()
    for p in q.fact_preds:
        ok = ok & p.mask(fact)
    rows = torch.nonzero(ok).flatten()
    pick = rng.choice(rows.shape[0], size=SERVE_CHECK_ROWS, replace=False)
    return rows[torch.from_numpy(pick).to(rows.device)]


def phase_data(dev):
    """The SF ``SF`` SSB tables, built once for the main path and serving."""
    import torch
    from repro_torch.data import generate_ssb
    t0 = time.perf_counter()
    data = generate_ssb(sf=SF, scale=1.0, seed=0, device=dev)
    torch.cuda.synchronize()
    emit(phase="main_data", sf=SF, lineorder_rows=data.lineorder.capacity,
         part_rows=data.part.capacity, seconds=time.perf_counter() - t0,
         device_bytes=torch.cuda.memory_allocated())
    return data


def phase_main(dev, data):
    """The port's main path at SF ``SF``: returns the kernels' launch
    counts, their inputs taken from it (for the kernels line), and each
    P-query plan's ``predict_rows`` on serving's check rows."""
    import numpy as np
    import torch
    from repro_torch.core.fusion import DecisionTreeGEMM
    from repro_torch.core.query import compile_query
    from repro_torch.data import QUERY_IR, predictive_query_names

    tables = data.tables()
    n = data.lineorder.capacity
    rng = np.random.default_rng(1)
    ids = rng.integers(0, n, size=ROW_BATCH)
    ids[:8] = [n, n + 5, -1, -n, -n - 1, 2**31 - 1, -(2**31), n - 1]
    row_ids = torch.from_numpy(ids.astype(np.int64)).to(dev)
    check_ids = {name: serve_check_ids(data.lineorder, QUERY_IR[name](), rng)
                 for name in predictive_query_names()}
    shapes = {}
    serve_want = {}

    reset_launches()
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
                    name, *k._state["stacked_joins"],
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
            if tree and backend == "nonfused":
                # The plan's tree ran its scores on tensor cores.
                times["tree_score_path"] = tree_score_path()[0]
                assert times["tree_score_path"] == "tensor cores", name
            rk, rt = k.predict_rows(row_ids), p.predict_rows(row_ids)
            assert same(rk, rt), f"{name} {backend} predict_rows"
            # serve vs predict_rows in the serving phase reads this batch.
            serve_want[name, backend] = k.predict_rows(check_ids[name])
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
    launches = read_launches()
    emit(phase="main_launches", **launches)
    for kname in ("fused_star_gather", "tree_predict"):
        if launches[kname] < 1:
            raise AssertionError(f"{kname} never launched on the main path")
    missing = {"fused_star_gather", "tree_predict"} - set(shapes)
    if missing:
        raise AssertionError(f"main path gave no shapes for {missing}")
    return launches, shapes, (check_ids, serve_want)


# ---------------------------------------------------------------- serving
def serving_traffic(catalog, q, rng, batches=SERVE_BATCHES):
    """``batches`` request batches cycling through ``SERVE_SIZES``: every
    other one the keys of random fact rows, the rest random keys over each
    dimension's key range widened by 1/16, so about 1 in 17 misses."""
    import numpy as np
    from repro_torch.core.query import requests_from_rows
    fact = catalog[q.fact]
    traffic = []
    for b in range(batches):
        n = SERVE_SIZES[b % len(SERVE_SIZES)]
        if b % 2 == 0:
            ids = rng.integers(0, int(fact.nvalid), size=n)
            traffic.append(requests_from_rows(fact, q, ids))
        else:
            traffic.append({
                a.fk_col: rng.integers(
                    0, int(catalog[a.table].nvalid) * 17 // 16 + 1,
                    size=n).astype(np.int32) for a in q.arms})
    return traffic


def serving_case(label, catalog, q, tree, check_ids, want_rows, rng):
    """Fused and nonfused runtimes under "kernel" and "torch" on one
    traffic: "kernel" equal to "torch" on every batch, and serving the check
    rows equal to ``predict_rows`` (exact for fused heads and trees, rtol
    ``LINEAR_SERVE_RTOL`` for nonfused linear heads)."""
    import torch
    from repro_torch.core.query import compile_serving, requests_from_rows
    traffic = serving_traffic(catalog, q, rng)
    check = requests_from_rows(catalog[q.fact], q, check_ids)
    for backend in ("fused", "nonfused"):
        outs = {}
        for serve in ("kernel", "torch"):
            rt = compile_serving(catalog, q, backend=backend,
                                 serve_backend=serve)
            t0 = time.perf_counter()
            outs[serve] = [rt.serve(r) for r in traffic]
            torch.cuda.synchronize()
            traffic_s = time.perf_counter() - t0
            for out, req in zip(outs[serve], traffic):
                n = len(next(iter(req.values())))
                assert tuple(out.shape) == (n, rt.out_width), label
            got = rt.serve(check)
            want = want_rows[backend]
            if backend == "fused" or tree:
                ok = same(got, want)
            else:
                ok = bool(torch.allclose(
                    got, want, rtol=LINEAR_SERVE_RTOL,
                    atol=LINEAR_SERVE_RTOL * float(want.abs().max())))
            assert ok, f"{label} {backend} {serve}: serve != predict_rows"
            emit(phase="serving", case=label, backend=backend,
                 serve=rt.serve_backend, batches=len(traffic),
                 rows=sum(len(next(iter(r.values()))) for r in traffic),
                 traffic_s=traffic_s, num_compiles=rt.num_compiles,
                 serve_equals_predict_rows=True,
                 latency_ms={str(b): v for b, v in
                             rt.latency_stats().items()})
            del rt
        for a, b in zip(outs["kernel"], outs["torch"]):
            assert same(a, b), f"{label} {backend}: kernel != torch"
        emit(phase="serving_kernel_vs_torch", case=label, backend=backend,
             equal=True)


def phase_serving(dev, data, main_serving):
    """Dynamic-batch serving at SF ``SF`` (P1–P4, the tables the main path
    built) and at the paper's setting 1.  Returns the launches it made."""
    import numpy as np
    import torch
    from repro_torch.core.fusion import (DecisionTreeGEMM, LinearOperator,
                                         random_tree)
    from repro_torch.core.query import compile_query, query_from_star
    from repro_torch.data import QUERY_IR, generate_star

    check_ids, serve_want = main_serving
    rng = np.random.default_rng(2)
    cases = []
    for name, ids in check_ids.items():
        q = QUERY_IR[name]()
        cases.append((f"SF {SF} {name}", data.tables(), q,
                      isinstance(q.model, DecisionTreeGEMM), ids,
                      {b: serve_want[name, b]
                       for b in ("fused", "nonfused")}))
    k, l, depth = 128, 128, 7
    syn = generate_star(1, 8, k, seed=1, scale=1.0, device=dev)
    lin = LinearOperator(torch.from_numpy(
        (rng.normal(size=(k, l)) / np.sqrt(k)).astype(np.float32)))
    for label, model in (("linear", lin), ("tree", random_tree(rng, k,
                                                               depth))):
        catalog, q = query_from_star(syn.star, model=model)
        ids = serve_check_ids(catalog[q.fact], q, rng)
        want = {b: compile_query(catalog, q, backend=b,
                                 serve_backend="kernel").predict_rows(ids)
                for b in ("fused", "nonfused")}
        cases.append((f"setting 1 sf 8 {label} k={k} l={model.l}", catalog,
                      q, label == "tree", ids, want))
    reset_launches()
    for case in cases:
        serving_case(*case, rng)
    launches = read_launches()
    emit(phase="serving_launches", **launches)
    for kname in ("fused_star_gather", "tree_predict"):
        if launches[kname] < 1:
            raise AssertionError(f"{kname} never launched while serving")
    del cases, syn
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- sharding
SHARD_MESHES = ((1, 8), (2, 4), (8, 1))   # 8 positions on one card each
SHARD_CASES = (("P1.linear.year", "fused"), ("P3.tree.year", "nonfused"))
SHARD_ROUNDS = 8              # rounds of SERVE_SIZES per sharded runtime
SHARD_PART_SLACK = 8000       # part slots past its rows: appends land in place
SHARD_APPEND = 800            # part rows appended before each refresh
SHARD_CYCLES = 3              # append → refresh cycles
SHARD_TIMES = 5               # predict_rows_ms: median of this many calls
SHARD_REFRESH_MESH = (2, 4)


def serving_state_bytes(rt) -> int:
    """Quasi-static bytes of a single-device runtime (partials or features,
    PK index, masks, ``h``): the sum ``nbytes_per_device`` divides."""
    tensors = [t for a in rt._arms for t in (a.table, a.index.sorted_pk,
                                             a.index.order, a.dmask)]
    tensors += [rt._h] if rt._h is not None else []
    return sum(t.numel() * t.element_size() for t in tensors)


def bucket_latency(rt) -> dict:
    """p50/p99 (ms) and samples per bucket of a runtime's latency_stats."""
    return {str(b): {k: v[k] for k in ("count", "p50", "p99") if k in v}
            for b, v in rt.latency_stats().items()}


def sharding_ids(fact, q, rng):
    """``ROW_BATCH`` predict_rows ids: rows that pass ``q``'s fact-side
    predicates (serving them must give predict_rows), then 8 ids outside
    the fact table; returns (ids, number of rows that pass)."""
    import torch
    ok = fact.valid_mask()
    for p in q.fact_preds:
        ok = ok & p.mask(fact)
    rows = torch.nonzero(ok).flatten()
    n_in = min(ROW_BATCH - 8, int(rows.shape[0]))
    pick = torch.from_numpy(rng.choice(rows.shape[0], size=n_in,
                                       replace=False)).to(rows.device)
    n = fact.capacity
    outside = torch.tensor([n, n + 5, 2**31 - 1, -n - 1, -(2**31), n + 1,
                            10 * n, n + 2], device=rows.device)
    return torch.cat([rows[pick], outside]), n_in


def sharding_refresh(dev, data, rng, card):
    """A versioned catalog over ``data`` with ``SHARD_PART_SLACK`` more part
    slots; P1 and P3 sharded runtimes and plans on a
    ``SHARD_REFRESH_MESH`` mesh at the planner's threshold; then
    ``SHARD_CYCLES`` appends of ``SHARD_APPEND`` part rows, each followed
    by every object's refresh (delta, indexing again only the shard blocks
    that own the new rows), and the refreshed objects against a cold
    sharded compile and a cold single-device one.  Returns the failures."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.laq import PAD_KEY
    from repro_torch.core.query import (compile_query, compile_serving,
                                        requests_from_rows)
    from repro_torch.data import QUERY_IR, ssb_catalog
    from repro_torch.launch.mesh import make_serving_mesh

    part = data.part
    cap = -(-(part.capacity + SHARD_PART_SLACK) // 8) * 8
    matrix = torch.zeros((cap, part.ncols), dtype=part.matrix.dtype,
                         device=part.device)
    matrix[:part.capacity] = part.matrix
    keys = {}
    for c, k in part.keys.items():
        keys[c] = torch.full((cap,), PAD_KEY, dtype=k.dtype,
                             device=part.device)
        keys[c][:part.capacity] = k
    cat = ssb_catalog(dataclasses.replace(data, part=dataclasses.replace(
        part, matrix=matrix, keys=keys)))
    mesh = make_serving_mesh(SHARD_REFRESH_MESH, device=dev)
    built = []
    for name, backend in SHARD_CASES:
        q = QUERY_IR[name]()
        built.append((name, backend, q,
                      [a.table for a in q.arms].index("part"),
                      compile_serving(cat, q, backend=backend, mesh=mesh),
                      compile_query(cat, q, backend=backend, mesh=mesh)))
    first = int(part.nvalid)
    bad = []
    report = {name: {"refresh_ms": [], "plan_refresh_ms": [],
                     "blocks_reindexed": [], "blocks_owning_append": []}
              for name, _ in SHARD_CASES}
    for _ in range(SHARD_CYCLES):
        start = int(cat["part"].nvalid)
        cat.append("part", part_rows(rng, start, SHARD_APPEND))
        for name, backend, q, j, rt, plan in built:
            before = rt.sharded.arms[j].sorted_pk.parts
            lines = {}
            rt_ms = host_ms(lambda: lines.update(rt=rt.refresh()))
            plan_ms = host_ms(lambda: lines.update(plan=plan.refresh()))
            after = rt.sharded.arms[j].sorted_pk.parts
            arm = rt.sharded.arms[j]
            rps = (arm.table.shape[0] // mesh.shape["model"]
                   if arm.is_sharded else arm.table.shape[0])
            r = report[name]
            r["refresh_ms"].append(rt_ms)
            r["plan_refresh_ms"].append(plan_ms)
            r["blocks_reindexed"].append(sorted(
                {s for key, s in after if after[key, s] is not before[key,
                                                                      s]}))
            r["blocks_owning_append"].append(list(range(
                start // rps, -(-(start + SHARD_APPEND) // rps))))
            r["runtime_line"], r["plan_line"] = lines["rt"], lines["plan"]
            if not (lines["rt"].startswith("refresh=delta(part+1")
                    and lines["plan"].startswith("refresh=delta(part+1")):
                bad.append(f"sharded refresh of {name}: {lines}")
    new_keys = np.arange(first, int(cat["part"].nvalid), dtype=np.int32)
    for name, backend, q, j, rt, plan in built:
        r = report[name]
        if r["blocks_reindexed"] != r["blocks_owning_append"]:
            bad.append(f"{name}: blocks {r['blocks_reindexed']} indexed "
                       f"again, the appended rows are in "
                       f"{r['blocks_owning_append']}")
        t = time.perf_counter()
        cold = compile_serving(cat, q, backend=backend, mesh=mesh)
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t) * 1e3
        single = compile_serving(cat, q, backend=backend,
                                 serve_backend="torch")
        traffic = serving_traffic(cat, q, rng, 2 * len(SERVE_SIZES))
        # Fact rows' keys, each with the part key of an appended row.
        fresh = requests_from_rows(cat[q.fact], q, rng.integers(
            0, int(cat[q.fact].nvalid), size=SERVE_CHECK_ROWS))
        fresh[q.arms[j].fk_col] = rng.choice(new_keys, size=SERVE_CHECK_ROWS)
        traffic.append(fresh)
        equal = all(same(rt.serve(x), cold.serve(x))
                    and same(rt.serve(x), single.serve(x)) for x in traffic)
        t = time.perf_counter()
        cold_plan = compile_query(cat, q, backend=backend, mesh=mesh)
        torch.cuda.synchronize()
        cold_plan_ms = (time.perf_counter() - t) * 1e3
        ids, _ = sharding_ids(cat[q.fact], q, rng)
        plan_equal = same(plan.predict_rows(ids), cold_plan.predict_rows(ids))
        if not (equal and plan_equal):
            bad.append(f"refreshed sharded {name} {backend} != cold "
                       f"(serve {equal}, predict_rows {plan_equal})")
        emit(phase="sharding_refresh", case=name, backend=backend,
             mesh=list(SHARD_REFRESH_MESH), appends=SHARD_CYCLES,
             rows_per_append=SHARD_APPEND, part_capacity=cap, **r,
             cold_compile_ms=cold_ms, plan_cold_compile_ms=cold_plan_ms,
             serve_equals_cold_sharded_and_single=equal,
             predict_rows_equals_cold=plan_equal, card=card)
        del cold, single, cold_plan
    del built, cat
    return bad


def phase_sharding(dev, data, card=None):
    """Sharded serving on virtual meshes of 8 positions on ``dev`` (every
    position the one card, so the shards run one after another there):
    P1 (fused) and P3 (nonfused tree) on meshes (1,8), (2,4) and (8,1), at
    the planner's threshold and at 0 (every divisible table sharded).  Each
    sharded runtime serves the same ragged traffic as a single-device
    ``"torch"`` runtime and must equal it bit for bit; each sharded plan's
    ``predict_rows`` (``ROW_BATCH`` ids, 8 outside the fact) must equal
    the single-device plan's, and serving the passing rows must equal it.
    Then the sharded refresh (``sharding_refresh``).  No kernel may launch:
    the reference's mesh path runs none.  Returns the launch counts."""
    import numpy as np
    import torch
    from repro_torch.core.query import (compile_query, compile_serving,
                                        requests_from_rows)
    from repro_torch.data import QUERY_IR
    from repro_torch.launch.mesh import make_serving_mesh

    t0 = time.perf_counter()
    tables = data.tables()
    fact = data.lineorder
    rng = np.random.default_rng(6)
    meshes = {s: make_serving_mesh(s, device=dev) for s in SHARD_MESHES}
    one = next(iter(meshes.values()))
    emit(phase="sharding_mesh", cards=torch.cuda.device_count(),
         devices=[str(d) for d in one.distinct_devices()],
         positions=one.size,
         shards_per_card=one.size // len(one.distinct_devices()),
         shapes=[list(s) for s in SHARD_MESHES], card=card)
    bad = []
    reset_launches()
    for name, backend in SHARD_CASES:
        q = QUERY_IR[name]()
        traffic = serving_traffic(tables, q, rng,
                                  SHARD_ROUNDS * len(SERVE_SIZES))
        single = compile_serving(tables, q, backend=backend,
                                 serve_backend="torch")
        t = time.perf_counter()
        want = [single.serve(r) for r in traffic]
        torch.cuda.synchronize()
        single_s = time.perf_counter() - t
        single_bytes = serving_state_bytes(single)
        ids, n_in = sharding_ids(fact, q, rng)
        flat = compile_query(tables, q, backend=backend,
                             serve_backend="torch")
        flat_rows = {"v": flat.predict_rows(ids)}
        flat_ms = median_ms(lambda: flat.predict_rows(ids), SHARD_TIMES)
        check = requests_from_rows(fact, q, ids[:n_in])
        emit(phase="sharding_single", case=name, backend=backend,
             state_bytes=single_bytes, traffic_s=single_s,
             predict_rows_ms=flat_ms, latency_ms=bucket_latency(single),
             card=card)
        for shape, mesh in meshes.items():
            for threshold in (None, 0):
                rt = compile_serving(tables, q, backend=backend, mesh=mesh,
                                     shard_threshold_bytes=threshold)
                t = time.perf_counter()
                outs = [rt.serve(r) for r in traffic]
                torch.cuda.synchronize()
                traffic_s = time.perf_counter() - t
                equal = all(same(a, b) for a, b in zip(outs, want))
                plan = compile_query(tables, q, backend=backend, mesh=mesh,
                                     shard_threshold_bytes=threshold)
                rows = {"v": plan.predict_rows(ids)}
                rows_ms = median_ms(lambda: plan.predict_rows(ids),
                                    SHARD_TIMES)
                rows_equal = same(rows["v"], flat_rows["v"])
                served = same(rt.serve(check), rows["v"][:n_in])
                label = f"{name} {backend} mesh {shape} threshold {threshold}"
                if not (equal and rows_equal and served):
                    bad.append(f"{label}: serve == single {equal}, "
                               f"predict_rows == single {rows_equal}, "
                               f"serve == predict_rows {served}")
                reason = rt.plan.reason
                per_pos = rt.sharded.nbytes_per_device()
                emit(phase="sharding", case=name, backend=backend,
                     mesh=list(shape), shard_threshold_bytes=threshold,
                     buckets=list(rt.buckets), serve=rt.serve_backend,
                     partition_specs=[list(p) for p in
                                      rt.plan.partition_specs],
                     place=reason[reason.rindex("place=["):],
                     num_sharded=rt.sharded.num_sharded,
                     nbytes_per_device=per_pos,
                     single_device_bytes=single_bytes,
                     bytes_ratio=per_pos / single_bytes,
                     plan_nbytes_per_device=plan._sp.nbytes_per_device(),
                     batches=len(traffic), traffic_s=traffic_s,
                     single_traffic_s=single_s,
                     serve_equals_single=equal,
                     predict_rows_equals_single=rows_equal,
                     serve_equals_predict_rows=served,
                     predict_rows_ms=rows_ms, single_predict_rows_ms=flat_ms,
                     latency_ms=bucket_latency(rt),
                     single_latency_ms=bucket_latency(single), card=card)
                del rt, plan, outs
        del single, flat, flat_rows, want
    bad += sharding_refresh(dev, data, rng, card)
    launches = read_launches()
    emit(phase="sharding_launches", **launches,
         seconds=time.perf_counter() - t0)
    if any(launches.values()):
        bad.append(f"the sharding phase launched kernels: {launches}")
    if bad:
        raise AssertionError("sharding:\n" + "\n".join(bad))
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------- onehot_matmul
ONEHOT_TEST_SHAPES = ((8, 16, 8), (128, 512, 128), (130, 513, 129),
                      (1, 7, 3), (256, 64, 384))     # tests/test_kernels.py
ONEHOT_BENCH_SHAPES = ((1024, 4096, 256), (8192, 16384, 512))


def onehot_bytes_ops(idx, table):
    """onehot_matmul: idx, the table and the output once each; the work the
    function needs is one select per output element and one finiteness
    test per table entry (the matmul's 2·n·r·d multiplies by 0 or 1)."""
    n = idx.shape[0]
    r, d = table.shape
    return (n * 4 + r * d * table.element_size() + n * d * 4,
            n * d + r * d)


def onehot_library_call(idx, table):
    """One PyTorch call computing the gather: ``index_select`` from the
    table with a zero row appended, out-of-range ids mapped to it (both
    prepared outside the timing; a yardstick only)."""
    import torch
    r, d = table.shape
    padded = torch.cat([table.float(), table.new_zeros((1, d),
                                                       dtype=torch.float32)])
    mapped = torch.where((idx >= 0) & (idx < r), idx, r)
    return lambda: padded.index_select(0, mapped)


def timed_once(fn):
    """(result, CUDA-event milliseconds) of one call."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


PLAIN_GATHER, NAN_RULE = "plain gather", "NaN rule"


def onehot_path():
    """The path the last ``onehot_matmul`` launch took, read back from its
    slab flags (waits for the card): the plain gather when every slab of
    the table was finite, else the NaN rule."""
    from repro_torch.kernels import onehot_matmul
    geom, scratch = onehot_matmul.last_launch
    return NAN_RULE if bool(scratch[:geom.slabs].any()) else PLAIN_GATHER


def check_onehot(label, idx, table, timing=False):
    """Kernel vs plain version, exactly, on the path the table calls for
    (the NaN rule only when it holds a NaN or ±Inf); with ``timing``, the
    kernel's (one call; and per call of 100 on the card and on the host),
    the plain version's (one call, reused for the comparison) and the
    library call's times."""
    import torch
    from repro_torch.kernels import onehot_matmul, onehot_matmul_ref
    before = onehot_matmul.launches
    got = onehot_matmul(idx, table)
    path = onehot_path() if onehot_matmul.launches > before else None
    expect = PLAIN_GATHER if bool(torch.isfinite(table).all()) else NAN_RULE
    if path != expect:
        raise AssertionError(f"onehot_matmul {label}: took the {path} path, "
                             f"expected the {expect} path")
    want, plain_ms = timed_once(lambda: onehot_matmul_ref(idx, table))
    torch.cuda.synchronize()
    if not same(got, want):
        raise AssertionError(f"onehot_matmul {label}: kernel != plain "
                             f"(max abs err {max_abs_err(got, want)})")
    row = dict(phase="kernel", kernel="onehot_matmul", case=label,
               n=int(idx.shape[0]), r=int(table.shape[0]),
               d=int(table.shape[1]), dtype=str(table.dtype).split(".")[1],
               equal=True, max_abs_err=max_abs_err(got, want), path=path)
    row["shape"] = {k: row[k] for k in ("n", "r", "d")}
    del got, want
    if timing:
        nbytes, ops = onehot_bytes_ops(idx, table)
        call = lambda: onehot_matmul(idx, table)  # noqa: E731
        row.update(bytes=nbytes, operations=ops, kernel_ms=time_ms(call),
                   device_ms=device_ms(call), host_us=host_us(call),
                   plain_ms=plain_ms, plain_reps=1,
                   library_ms=time_ms(onehot_library_call(idx, table)))
        row["bound_ms"], row["bound_by"], row["bound_rate"] = bound(nbytes,
                                                                   ops)
    emit(**row)
    return row


def onehot_sf_inputs(data):
    """SF ``SF``: every lineorder row's supplier position (from the PK
    probe) and supplier's feature matrix."""
    from repro_torch.core.laq import pk_index
    supplier = data.supplier
    pos = pk_index(supplier.key("suppkey")).probe(
        data.lineorder.key("lo_suppkey")).ptr.contiguous()
    return pos, supplier.matrix.contiguous()


def onehot_slab_edges(rng, t):
    """The count pass's row slabs and the gather's two paths: non-finite
    entries in the first slab, a middle one and the last, a column whose one
    NaN no row selects, an all-NaN column, r = 1 (one slab), r = 0 (none),
    d = 1, and bf16 rows of d % 8 != 0 (no 16-byte row starts), each also
    all finite (the plain gather)."""
    import numpy as np
    import torch
    from repro_torch.kernels.onehot_matmul.ops import launch_geometry
    r, d = 20000, 8
    geom = launch_geometry(1, r, d, True)    # slabs depend on r, d only
    assert geom.slabs >= 3
    mid = (geom.slabs // 2) * geom.slab_rows + 3
    idx = rng.integers(11, r - 1, size=4096).astype(np.int32)
    idx[:6] = [0, mid, r - 1, -1, r, -(2**31)]
    for dtype in (torch.float32, torch.bfloat16):
        tbl = rng.normal(size=(r, d)).astype(np.float32)
        check_onehot(f"edge finite r={r} d={d}", t(idx, torch.int32),
                     t(tbl, dtype))
        tbl[0, 1], tbl[mid, 3], tbl[r - 1, 1] = np.inf, -np.inf, np.nan
        tbl[10, 6] = np.nan                     # selected by no row
        check_onehot(f"edge non-finite in slabs 0, {geom.slabs // 2}, "
                     f"{geom.slabs - 1} of {geom.slabs}",
                     t(idx, torch.int32), t(tbl, dtype))
        tbl[:, 5] = np.nan
        check_onehot("edge all-NaN column", t(idx, torch.int32),
                     t(tbl, dtype))
        for r_, d_ in ((1, 7), (0, 4), (1000, 1), (300, 12), (300, 13)):
            ids = t(rng.integers(-2, r_ + 2, size=999).astype(np.int32),
                    torch.int32)
            tbl = rng.normal(size=(r_, d_)).astype(np.float32)
            check_onehot(f"edge r={r_} d={d_}", ids, t(tbl, dtype))
            if r_:
                tbl[r_ // 2, d_ - 1] = np.inf
                check_onehot(f"edge r={r_} d={d_} one Inf", ids,
                             t(tbl, dtype))


def phase_onehot(dev, data):
    """``onehot_matmul`` against its plain version.  No query path calls it
    (nor the reference's), so it is driven here: the reference's test and
    bench shapes, edge cases, and one shape from this system's data — the
    SF ``SF`` lineorder supplier positions (from the PK probe) into the
    supplier matrix.  Returns that shape's row and the phase's launches."""
    import numpy as np
    import torch
    from repro_torch.kernels import onehot_matmul

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    reset_launches()
    for n, r, d in ONEHOT_TEST_SHAPES:
        rng = np.random.default_rng(n * 1000 + r + d)
        idx = t(rng.integers(-2, r + 2, size=n).astype(np.int32), torch.int32)
        tbl = rng.normal(size=(r, d)).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            check_onehot(f"test n={n} r={r} d={d}", idx, t(tbl, dtype))
    rng = np.random.default_rng(0)
    for n, r, d in ONEHOT_BENCH_SHAPES:
        idx = t(rng.integers(0, r, n).astype(np.int32), torch.int32)
        check_onehot(f"bench n={n} r={r} d={d}", idx,
                     t(rng.normal(size=(r, d))), timing=True)
    # Edges: non-finite entries (a column whose only one is some row's own
    # entry stays ±Inf there), extreme indices, an unaligned table (no
    # vector loads), an empty batch, and n·d above 2**31.
    for dtype in (torch.float32, torch.bfloat16):
        tbl = rng.normal(size=(513, 129)).astype(np.float32)
        tbl[5, 7] = np.nan
        tbl[100, 128] = np.inf
        tbl[7, 0], tbl[8, 0] = -np.inf, np.nan
        idx = rng.integers(-3, 516, size=1000).astype(np.int32)
        idx[:6] = [100, 5, 7, 8, -(2**31), 2**31 - 1]
        check_onehot("edge non-finite r=513 d=129", t(idx, torch.int32),
                     t(tbl, dtype))
    buf = t(rng.normal(size=64 * 8 + 1))
    check_onehot("edge unaligned r=64 d=8",
                 t(rng.integers(-1, 65, 777).astype(np.int32), torch.int32),
                 buf[1:].view(64, 8))
    onehot_slab_edges(rng, t)
    before = onehot_matmul.launches
    empty = onehot_matmul(torch.zeros(0, dtype=torch.int32, device=dev),
                          t(tbl))
    assert tuple(empty.shape) == (0, 129) and onehot_matmul.launches == before
    for d in (4, 5):
        n = ONEHOT_BIG_ROWS
        idx = torch.randint(-1, 6, (n,), dtype=torch.int32, device=dev,
                            generator=torch.Generator(dev).manual_seed(d))
        check_onehot(f"edge n*d={n * d} r=5 d={d}", idx,
                     t(rng.normal(size=(5, d))))
        del idx
        torch.cuda.empty_cache()
    pos, matrix = onehot_sf_inputs(data)
    row = check_onehot(f"SF {SF} lineorder->supplier", pos, matrix,
                       timing=True)
    launches = onehot_matmul.launches
    emit(phase="onehot_launches", onehot_matmul=launches)
    del pos
    torch.cuda.empty_cache()
    return row, launches


# -------------------------------------------------------------- lifecycle
LIFECYCLE_SLACK = 1.12        # capacity over rows: appends land in place
LIFECYCLE_QUERIES = (("P1.linear.year", "fused"),
                     ("P3.tree.year", "nonfused"))
LIFECYCLE_IDS = 4096          # predict_rows batch per step


def lifecycle_catalog(dev, sf=SF, scale=1.0):
    """SSB at ``sf`` with ``LIFECYCLE_SLACK`` capacity, as a versioned
    Catalog.  The generator makes every integer-coded attribute an exact
    key column, and a key column cannot be updated in place (the
    reference's rule); ``part.p_size``, a feature of P1 and P3 read from
    the float matrix, is kept out of the keys so that it can be."""
    import dataclasses
    from repro_torch.data import generate_ssb, ssb_catalog
    data = generate_ssb(sf=sf, scale=scale, seed=0,
                        capacity_slack=LIFECYCLE_SLACK, device=dev)
    data = dataclasses.replace(data, part=dataclasses.replace(
        data.part, keys={c: k for c, k in data.part.keys.items()
                         if c != "p_size"}))
    return ssb_catalog(data)


def part_rows(rng, start, m):
    """``m`` new part rows with fresh keys from ``start``, drawn as
    ``data/ssb.py`` draws part (the appended data is made here, not by the
    package)."""
    import numpy as np
    mfgr = rng.integers(0, 5, m)
    category = mfgr * 5 + rng.integers(0, 5, m)
    return {"partkey": np.arange(start, start + m), "p_mfgr": mfgr,
            "p_category": category,
            "p_brand1": category * 40 + rng.integers(0, 40, m),
            "p_size": rng.integers(1, 51, m)}


def lineorder_rows(rng, cat, m):
    """``m`` new lineorder rows whose foreign keys range over every live
    dimension row (appended part rows included)."""
    import numpy as np
    lo = cat["lineorder"]
    start = int(lo.nvalid)
    size = {t: int(cat[t].nvalid) for t in ("part", "supplier", "customer",
                                             "date")}
    return {"lo_orderkey": np.arange(start, start + m),
            "lo_custkey": rng.integers(0, size["customer"], m),
            "lo_partkey": rng.integers(0, size["part"], m),
            "lo_suppkey": rng.integers(0, size["supplier"], m),
            "lo_orderdate": rng.integers(0, size["date"], m),
            "lo_quantity": rng.integers(1, 51, m),
            "lo_extendedprice": rng.integers(1, 6_000_00, m) / 100.0,
            "lo_discount": rng.integers(0, 11, m),
            "lo_revenue": rng.integers(1, 6_000_00, m) / 100.0,
            "lo_supplycost": rng.integers(1, 1_000_00, m) / 100.0}


def lifecycle_steps(cat, rng):
    """The mutations, in order, as (label, table, kind, apply): appends of
    0.1, 1 and 10 % of part (the reference bench's ``FRACTIONS``), 0.1 % of
    lineorder, an update of a part feature column, deletions from part and
    lineorder, compaction of part and an append past part's capacity.
    ``kind`` names the route the reference takes: "delta", "compaction"
    or "capacity-growth".  ``apply()`` returns the part rows it changed
    (None when it changed none, or moved them)."""
    import numpy as np

    next_key = [int(cat["part"].nvalid)]   # part keys are 0..n-1

    def append_part(m):
        lo = int(cat["part"].nvalid)
        cat.append("part", part_rows(rng, next_key[0], m))
        next_key[0] += m
        return np.arange(lo, lo + m)

    def update():
        ids = rng.choice(int(cat["part"].nvalid), size=1000, replace=False)
        cat.update_column("part", "p_size", ids,
                          rng.integers(1, 51, ids.shape[0]))
        return ids

    def delete_part():
        ids = rng.choice(int(cat["part"].nvalid), size=1000, replace=False)
        cat.delete_rows("part", ids)
        return ids

    def append_lineorder():
        cat.append("lineorder", lineorder_rows(rng, cat, m_lo))

    def delete_lineorder():
        cat.delete_rows("lineorder", np.arange(m_lo))

    def compact():
        assert cat.compact("part", threshold=0.0)

    def grow():
        t = cat["part"]
        m = t.capacity - int(t.nvalid) + 1000
        return append_part(m)

    n_part = int(cat["part"].nvalid)
    m_lo = int(cat["lineorder"].nvalid) // 1000
    steps = [(f"append part {frac:.1%} ({int(n_part * frac)} rows)", "part",
              "delta", lambda m=int(n_part * frac): append_part(m))
             for frac in (0.001, 0.01, 0.1)]
    steps += [
        (f"append lineorder 0.1% ({m_lo} rows)", "lineorder", "delta",
         append_lineorder),
        ("update part.p_size (1000 rows)", "part", "delta", update),
        ("delete part (1000 rows)", "part", "delta", delete_part),
        (f"delete lineorder 0.1% (rows [0, {m_lo}))", "lineorder", "delta",
         delete_lineorder),
        ("compact part", "part", "compaction", compact),
        ("append part past capacity", "part", "capacity-growth", grow),
    ]
    return steps


def expected_lines(table, kind, serving):
    """The decision line the reference writes for one step's refresh (the
    runtime reads no fact table: a lineorder step is a no-op there)."""
    if serving:
        if table == "lineorder":
            return "refresh=no-op(versions unchanged)"
        if kind == "delta":
            return f"refresh=delta({table}+1; shapes kept, 0 new compiles)"
        why = ("compaction:part rewrote row ids" if kind == "compaction"
               else f"capacity-growth:{table}")
        return f"refresh=rebuild({why}; replanned, jit cache reset)"
    if kind == "delta":
        return f"refresh=delta({table}+1; shapes kept, jit cache reused)"
    if kind == "compaction":
        return f"refresh=recompile(compaction:{table} rewrote row ids)"
    return f"refresh=recompile(capacity-growth:{table})"


def rows_differ(a, b) -> int:
    """Rows of two (r, l) tensors that differ anywhere (NaN equal NaN)."""
    import torch
    if a.shape != b.shape:
        return max(a.shape[0], b.shape[0])
    eq = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return int((~eq).reshape(a.shape[0], -1).any(dim=1).sum())


def lifecycle_traffic(cat, q, rng, changed_keys):
    """Request batches for one step: fact rows' keys and random keys at
    each of ``SERVE_SIZES``, and (``changed_keys``) one batch whose part
    keys are those of part rows the step changed."""
    import numpy as np
    from repro_torch.core.query import requests_from_rows
    fact = cat[q.fact]
    out = []
    for n in SERVE_SIZES:
        out.append(requests_from_rows(
            fact, q, rng.integers(0, int(fact.nvalid), size=n)))
        out.append({a.fk_col: rng.integers(
            0, int(cat[a.table].nvalid) * 17 // 16 + 1,
            size=n).astype(np.int32) for a in q.arms})
    if changed_keys is not None:
        n = changed_keys.shape[0]
        req = {a.fk_col: rng.integers(0, int(cat[a.table].nvalid),
                                      size=n).astype(np.int32)
               for a in q.arms}
        req["lo_partkey"] = changed_keys.astype(np.int32)
        out.append(req)
    return out


def kernel_vs_plain_on(plan):
    """The plan's kernel against its plain version on its refreshed state
    (the launches made here are taken back off the counters: they are no
    part of the path)."""
    import torch
    from repro_torch.kernels import (fused_star_gather,
                                     fused_star_gather_ref, tree_predict,
                                     tree_predict_ref)
    saved = read_launches()
    out = {}
    if plan.backend == "fused":
        st = plan._state
        args = (*st["stacked_joins"], list(st["partials"]), st["h"])
        got, want = fused_star_gather(*args), fused_star_gather_ref(*args)
        name = "fused_star_gather"
    else:
        m = plan.query.model
        args = (plan.star.materialize().contiguous(), m.F, m.v, m.H, m.h)
        got, want = tree_predict(*args), tree_predict_ref(*args)
        name = "tree_predict"
    torch.cuda.synchronize()
    if not same(got, want):
        raise AssertionError(f"{name} on refreshed state: kernel != plain "
                             f"(max abs err {max_abs_err(got, want)})")
    out[name] = {"equal": True, "max_abs_err": max_abs_err(got, want)}
    for k, fn in kernel_wrappers().items():
        fn.launches = saved[k]
    return out


def lifecycle_step(label, table, kind, changed, cat, objects, rng, counts):
    """Refresh every plan and runtime after one step, check each against a
    cold compile on the same catalog and emit the step's line."""
    import numpy as np
    import torch
    from repro_torch.core.query import compile_query, compile_serving
    from repro_torch.data import QUERY_IR
    n_fact = int(cat["lineorder"].nvalid)
    ids = rng.integers(0, n_fact, size=LIFECYCLE_IDS)
    ids[:4] = [n_fact - 1, n_fact - 2, 0, 1]
    row_ids = torch.from_numpy(ids.astype(np.int64)).to(
        cat["lineorder"].device)
    changed_keys = None
    if changed is not None:
        pick = torch.from_numpy(rng.choice(changed, size=min(
            512, changed.shape[0]), replace=False)).to(cat["part"].device)
        changed_keys = cat["part"].key("partkey")[pick].cpu().numpy()
    row = dict(phase="lifecycle", step=label, table=table, route=kind,
               versions=dict(cat.versions()), objects={})
    step_launches = {k: 0 for k in kernel_wrappers()}

    def drive(fn):
        """Call ``fn`` and count its launches as the lifecycle path's."""
        box = {}
        for k, v in launches_of(lambda: box.update(v=fn())).items():
            step_launches[k] += v
        return box["v"]

    for name, backend in LIFECYCLE_QUERIES:
        q = QUERY_IR[name]()
        tree = backend == "nonfused"
        plan, rt = objects[name]
        obj = {}
        # -- the compiled query
        box = {}
        refresh_ms = host_ms(lambda: box.update(line=plan.refresh()))
        want_line = expected_lines(table, kind, serving=False)
        if box["line"] != want_line:
            raise AssertionError(f"{name} {label}: query refresh said "
                                 f"{box['line']!r}, the reference's route "
                                 f"is {want_line!r}")
        cold_box = {}
        cold_ms = host_ms(lambda: cold_box.update(p=compile_query(
            cat, q, backend=backend, serve_backend="kernel")))
        cold = cold_box["p"]
        got_run = drive(plan.run)
        _assert_run(got_run, cold.run(), tree, f"{name} {label} run")
        _finite_outputs(got_run, f"{name} {label}")
        assert same(drive(plan.predictions), cold.predictions()), \
            f"{name} {label}: predictions differ from a cold compile"
        assert same(drive(lambda: plan.predict_rows(row_ids)),
                    cold.predict_rows(row_ids)), \
            f"{name} {label}: predict_rows differs from a cold compile"
        differ = 0
        if plan.prefused is not None:
            differ = sum(rows_differ(a, b) for a, b in zip(
                plan.prefused.partials, cold.prefused.partials))
        if differ:
            raise AssertionError(f"{name} {label}: {differ} prefused rows "
                                 "differ from a cold prefuse")
        obj["query"] = dict(
            refresh_ms=refresh_ms, cold_compile_ms=cold_ms,
            ratio=refresh_ms / cold_ms, line=box["line"],
            reference_line=want_line, prefused_rows_differ=differ,
            run_equal="exact" if tree else f"rtol {LINEAR_AGG_RTOL}",
            predictions_equal=True, predict_rows_equal=True)
        obj["kernel_vs_plain"] = kernel_vs_plain_on(plan)
        del cold
        # -- the serving runtime
        before = (rt.num_compiles, rt.generation)
        box = {}
        refresh_ms = host_ms(lambda: box.update(line=rt.refresh()))
        want_line = expected_lines(table, kind, serving=True)
        if box["line"] != want_line:
            raise AssertionError(f"{name} {label}: runtime refresh said "
                                 f"{box['line']!r}, the reference's route "
                                 f"is {want_line!r}")
        if kind == "delta" and (rt.num_compiles, rt.generation) != before:
            raise AssertionError(f"{name} {label}: a delta refresh added "
                                 f"a compile ({before} -> "
                                 f"{(rt.num_compiles, rt.generation)})")
        after = (rt.num_compiles, rt.generation)
        cold_box = {}
        cold_ms = host_ms(lambda: cold_box.update(r=compile_serving(
            cat, q, backend=backend, serve_backend="kernel")))
        cold_rt = cold_box["r"]
        differ = sum(rows_differ(a.table, b.table)
                     for a, b in zip(rt._arms, cold_rt._arms))
        for a, b in zip(rt._arms, cold_rt._arms):
            assert same(a.dmask, b.dmask), f"{name} {label}: dmask"
            assert same(a.index.sorted_pk, b.index.sorted_pk), name
            assert same(a.index.order, b.index.order), name
        if differ:
            raise AssertionError(f"{name} {label}: {differ} serving table "
                                 "rows differ from a cold build")
        traffic = lifecycle_traffic(cat, q, rng, changed_keys)
        for req in traffic:
            got = drive(lambda: rt.serve(req))
            assert same(got, cold_rt.serve(req)), \
                f"{name} {label}: serve differs from a cold build"
        obj["serving"] = dict(
            refresh_ms=refresh_ms, cold_compile_ms=cold_ms,
            ratio=refresh_ms / cold_ms, line=box["line"],
            reference_line=want_line, table_rows_differ=differ,
            num_compiles_before=before[0], num_compiles=after[0],
            generation=after[1], batches=len(traffic), serve_equal=True)
        del cold_rt
        row["objects"][name] = obj
    torch.cuda.empty_cache()
    for k, v in step_launches.items():
        counts[k] += v
    row["launches"] = step_launches
    emit(**row)


def phase_lifecycle(dev, sf=SF, scale=1.0):
    """The data lifecycle at SSB SF ``sf``: a versioned catalog with
    capacity slack; P1 (fused, so ``fused_star_gather``) and P3 (nonfused
    tree, so ``tree_predict``) compiled as queries and as serving runtimes
    under ``"kernel"``; then each step of ``lifecycle_steps`` followed by a
    refresh of all four, each held against a cold compile on the same
    catalog, with the decision line held against the reference's route.
    The counters are zeroed just before and read just after; both kernels
    must launch on the refreshed state.  Returns the launches."""
    import numpy as np
    import torch
    from repro_torch.core.query import compile_query, compile_serving
    from repro_torch.data import QUERY_IR
    t0 = time.perf_counter()
    cat = lifecycle_catalog(dev, sf, scale)
    torch.cuda.synchronize()
    emit(phase="lifecycle_data", sf=sf, scale=scale,
         capacity_slack=LIFECYCLE_SLACK,
         rows={n: int(t.nvalid) for n, t in cat.items()},
         capacity={n: t.capacity for n, t in cat.items()},
         seconds=time.perf_counter() - t0,
         device_bytes=torch.cuda.memory_allocated())
    rng = np.random.default_rng(3)
    objects = {}
    for name, backend in LIFECYCLE_QUERIES:
        q = QUERY_IR[name]()
        rt = compile_serving(cat, q, backend=backend, serve_backend="kernel")
        for n in SERVE_SIZES:          # every bucket has had its first call
            rt.serve({a.fk_col: np.zeros(n, np.int32) for a in q.arms})
        objects[name] = (compile_query(cat, q, backend=backend,
                                       serve_backend="kernel"), rt)
    counts = {k: 0 for k in kernel_wrappers()}
    reset_launches()
    for label, table, kind, apply in lifecycle_steps(cat, rng):
        changed = apply()
        lifecycle_step(label, table, kind, changed, cat, objects, rng,
                       counts)
    launches = read_launches()
    # ``launches`` counts every call of the phase (cold compiles included);
    # ``refreshed`` only the refreshed plans' and runtimes' own calls.
    emit(phase="lifecycle_launches", **launches, refreshed=counts)
    for kname in ("fused_star_gather", "tree_predict"):
        if counts[kname] < 1:
            raise AssertionError(f"{kname} never launched on refreshed "
                                 "state")
    del objects, cat
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------- multi-query
MQ_REPS = 3                   # run_all / per-plan run timings (median)
MQ_SPANS = ((0, 700), (500, 1500), (1200, 2555))   # order dates per member
MQ_CLASSES = (("P1.linear.year", "fused"), ("P3.tree.year", "nonfused"))
MQ_THREADS = 4
MQ_INTERACTIVE = 75           # interactive requests per thread and plan
MQ_BATCH_ROWS = 16000         # rows of one analytical request (< lane bound)
MQ_WAIT_S = 600               # longest any scheduled result may take


def median_ms(fn, reps: int = MQ_REPS) -> float:
    return statistics.median(host_ms(fn) for _ in range(reps))


def _mq_members(name):
    """Three members of ``name``'s stack class: the registry query with one
    order-date span each (predicates live in the state)."""
    import dataclasses
    from repro_torch.core.laq import Pred
    from repro_torch.data import QUERY_IR
    base = QUERY_IR[name]()
    return [dataclasses.replace(base, fact_preds=base.fact_preds + (
        Pred("lo_orderdate", "between", span),)) for span in MQ_SPANS]


def _same_plan_opts(plan) -> dict:
    return dict(backend=plan.backend, join_backend=plan.join_backend,
                agg_backend=plan.agg_backend, serve_backend=plan.serve_backend)


def phase_mq_registry(sess, card):
    """``Session.run_all`` over the whole registry against unpooled plans
    of the same backends (compiled one at a time, so that they never hold
    their artifacts all at once)."""
    import torch
    from repro_torch.core.fusion import DecisionTreeGEMM
    from repro_torch.core.query import (artifact_bytes, compile_query,
                                        stack_key)
    from repro_torch.data import QUERY_IR
    names = list(QUERY_IR)
    qs = [QUERY_IR[n]() for n in names]
    t0 = time.perf_counter()
    plans = [sess.compile(q) for q in qs]
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    box = {}
    run_all_ms = median_ms(lambda: box.update(out=sess.run_all(qs)))
    got = box["out"]
    run_ms = {n: median_ms(p.run) for n, p in zip(names, plans)}
    classes = {}
    for n, p in zip(names, plans):
        classes.setdefault(stack_key(p), []).append(n)
    unpooled_ms, unpooled_bytes = {}, 0
    for n, q, p, r in zip(names, qs, plans, got):
        solo = compile_query(sess.catalog, q, **_same_plan_opts(p))
        want = solo.run()
        _assert_run(r, want, isinstance(q.model, DecisionTreeGEMM),
                    f"run_all {n}")
        _finite_outputs(r, f"run_all {n}")
        unpooled_ms[n] = median_ms(solo.run)
        unpooled_bytes += artifact_bytes([solo])
        del solo, want
    torch.cuda.empty_cache()
    emit(phase="multiquery_registry", card=card, queries=len(names),
         reps=MQ_REPS, compile_s=compile_s, stack_classes=len(classes),
         classes=sorted(classes.values()), run_all_ms=run_all_ms,
         sum_run_ms=sum(run_ms.values()),
         sum_unpooled_run_ms=sum(unpooled_ms.values()), run_ms=run_ms,
         unpooled_run_ms=unpooled_ms, pool=sess.pool.stats(),
         artifact_bytes=artifact_bytes(plans),
         unpooled_artifact_bytes=unpooled_bytes,
         run_all_equal=f"exact on integer data, rtol {LINEAR_AGG_RTOL}")


def _class_kernel_vs_plain(plan, states):
    """The class's kernel against its plain version on the class's state:
    the inputs ``predict_class`` gives the kernel (launches taken back off
    the counters: they are no part of the path)."""
    import torch
    from repro_torch.kernels import (fused_star_gather,
                                     fused_star_gather_ref, tree_predict,
                                     tree_predict_ref)
    from repro_torch.core.query.compile import _star_view
    saved = read_launches()
    st = states[0]
    if plan.backend == "fused":
        args = (*st["stacked_joins"], list(st["partials"]), st["h"])
        got, want = fused_star_gather(*args), fused_star_gather_ref(*args)
        name = "fused_star_gather"
    else:
        m = plan.query.model
        x = _star_view(plan.star, st).features().contiguous()
        args = (x, m.F, m.v, m.H, m.h)
        got, want = tree_predict(*args), tree_predict_ref(*args)
        name = "tree_predict"
    torch.cuda.synchronize()
    if not same(got, want):
        raise AssertionError(f"{name} on a stacked class: kernel != plain "
                             f"(max abs err {max_abs_err(got, want)})")
    for k, fn in kernel_wrappers().items():
        fn.launches = saved[k]
    return {name: {"equal": True, "max_abs_err": max_abs_err(got, want)}}


def phase_mq_stacked(sess, card):
    """A 3-member fused P1 class and a 3-member nonfused P3 class under
    ``"kernel"``: one launch of the class's kernel per ``run_all``, results
    against each member's ``run()``, unpooled kernel plans and ``"torch"``
    plans."""
    import torch
    from repro_torch.core.query import (compile_query, make_stacked_runner,
                                        stack_key, stack_states)
    rows = {}
    for name, backend in MQ_CLASSES:
        tree = backend == "nonfused"
        members = _mq_members(name)
        kw = dict(backend=backend, serve_backend="kernel")
        plans = [sess.compile(q, **kw) for q in members]
        if len({stack_key(p) for p in plans}) != 1:
            raise AssertionError(f"{name}: members in different classes")
        box = {}
        per_call = launches_of(lambda: box.update(out=sess.run_all(
            members, **kw)))
        kname = "fused_star_gather" if backend == "fused" else "tree_predict"
        if per_call[kname] != 1 or sum(per_call.values()) != 1:
            raise AssertionError(f"{name}: run_all launched {per_call}, "
                                 f"not one {kname}")
        run_all_ms = median_ms(lambda: sess.run_all(members, **kw))
        member_ms = sum(median_ms(p.run) for p in plans)
        for q, p, r in zip(members, plans, box["out"]):
            _assert_run(r, p.run(), tree, f"{name} stacked vs run()")
            for serve in ("kernel", "torch"):
                solo = compile_query(sess.catalog, q, backend=backend,
                                     serve_backend=serve)
                _assert_run(r, solo.run(), tree,
                            f"{name} stacked vs unpooled {serve}")
                del solo
        # Unpooled members share no tensors: the member axis, one launch
        # over their rows side by side.
        unpooled = [compile_query(sess.catalog, q, **kw) for q in members]
        runner = make_stacked_runner(unpooled[0]._online_fn)
        box = {}
        axis_call = launches_of(lambda: box.update(out=runner(stack_states(
            [p._state for p in unpooled]))))
        if axis_call[kname] != 1:
            raise AssertionError(f"{name}: member axis launched "
                                 f"{axis_call}")
        for slot, p in enumerate(unpooled):
            want = {k: v for k, v in p.run().items()
                    if k not in ("rows", "groups")}
            got = {k: v[slot] for k, v in box["out"].items()}
            got["rows"] = want["rows"] = p._rows
            _assert_run(got, want, tree, f"{name} member axis")
        del unpooled, runner, box
        torch.cuda.empty_cache()
        rows[name] = dict(
            backend=backend, members=len(members), stack_classes=1,
            run_all_ms=run_all_ms, sum_member_run_ms=member_ms,
            run_all_launches=per_call, member_axis_launches=axis_call,
            kernel_vs_plain=_class_kernel_vs_plain(
                plans[0], [p._state for p in plans]),
            equal=("exact" if tree else f"rtol {LINEAR_AGG_RTOL}")
            + " vs run(), unpooled kernel and torch plans, member axis")
        for q in members:
            sess.evict(q)
    emit(phase="multiquery_stacked", card=card, reps=MQ_REPS, classes=rows)


def mq_runtimes(sess):
    """The session's P1 (fused) and P3 (nonfused tree) serving runtimes
    under ``"kernel"``."""
    import numpy as np
    from repro_torch.data import QUERY_IR
    out = {}
    for name, backend in MQ_CLASSES:
        q = QUERY_IR[name]()
        rt = sess.serving(q, backend=backend, serve_backend="kernel")
        for n in SERVE_SIZES:          # every bucket has had its first call
            rt.serve({a.fk_col: np.zeros(n, np.int32) for a in q.arms})
        out[name] = rt
    return out


def phase_mq_refresh(sess, rng, card):
    """An append of 0.1 % of part through the session: each pooled object's
    decision line against the reference's, each object against a cold
    compile on the same catalog, pooled refresh time against unpooled."""
    import numpy as np
    import torch
    from repro_torch.core.fusion import DecisionTreeGEMM
    from repro_torch.core.query import compile_query, compile_serving
    from repro_torch.data import QUERY_IR
    cat = sess.catalog
    runtimes = mq_runtimes(sess)
    # Unpooled twins of every part-reading object, refreshed one by one.
    reads_part = [n for n in QUERY_IR
                  if any(a.table == "part" for a in QUERY_IR[n]().arms)]
    twins = {n: compile_query(cat, QUERY_IR[n](), **_same_plan_opts(
        sess.compile(QUERY_IR[n]()))) for n in reads_part}
    twins.update({(n, b): compile_serving(cat, QUERY_IR[n](), backend=b,
                                          serve_backend="kernel")
                  for n, b in MQ_CLASSES})
    m = int(cat["part"].nvalid) // 1000
    t0 = time.perf_counter()
    cat.append("part", part_rows(rng, int(cat["part"].nvalid), m))
    torch.cuda.synchronize()
    grow_ms = (time.perf_counter() - t0) * 1e3
    before = sess.pool.stats()["updates"]
    box = {}
    pooled_ms = host_ms(lambda: box.update(lines=sess.refresh()))
    lines = box["lines"]
    want = {"CompiledQuery":
            "refresh=delta(part+1; pooled artifacts, jit cache reused)",
            "ServingRuntime":
            "refresh=delta(part+1; pooled artifacts, 0 new compiles)"}
    for desc, line in lines.items():
        if line != want[desc.split("[")[0]]:
            raise AssertionError(f"{desc}: {line!r}, the reference's is "
                                 f"{want[desc.split('[')[0]]!r}")
    if len(lines) != len(reads_part) + len(runtimes):
        raise AssertionError(f"refresh touched {sorted(lines)}")
    box = {}
    unpooled_ms = host_ms(lambda: box.update(
        lines={str(k): t.refresh() for k, t in twins.items()}))
    differ = 0
    for n in reads_part:
        q = QUERY_IR[n]()
        plan = sess.compile(q)
        cold = compile_query(cat, q, **_same_plan_opts(plan))
        tree = isinstance(q.model, DecisionTreeGEMM)
        _assert_run(plan.run(), cold.run(), tree, f"refreshed {n}")
        _assert_run(twins[n].run(), cold.run(), tree, f"unpooled {n}")
        if q.model is not None:
            assert same(plan.predictions(), cold.predictions()), n
        if plan.prefused is not None:
            differ += sum(rows_differ(a, b) for a, b in zip(
                plan.prefused.partials, cold.prefused.partials))
        del cold
    if differ:
        raise AssertionError(f"{differ} pooled partial rows differ from a "
                             "cold prefuse")
    for (name, backend), rt in zip(MQ_CLASSES, runtimes.values()):
        q = QUERY_IR[name]()
        cold = compile_serving(cat, q, backend=backend,
                               serve_backend="kernel")
        for req in lifecycle_traffic(cat, q, rng, None):
            assert same(rt.serve(req), cold.serve(req)), name
            assert same(twins[name, backend].serve(req), cold.serve(req))
        del cold
    del twins
    torch.cuda.empty_cache()
    emit(phase="multiquery_refresh", card=card, appended_rows=m,
         objects=len(lines), grow_ms=grow_ms, pooled_refresh_ms=pooled_ms,
         unpooled_refresh_ms=unpooled_ms, unpooled_objects=len(box["lines"]),
         lines=lines, reference_lines=want, unpooled_lines=box["lines"],
         entries_updated=sess.pool.stats()["updates"] - before,
         entries=sess.pool.stats()["entries"], prefused_rows_differ=differ,
         run_equal=f"exact on integer data, rtol {LINEAR_AGG_RTOL}",
         predictions_equal=True, serve_equal=True)


def _mq_traffic(cat, q, rng, n_requests):
    """Interactive requests of 1–8 rows: fact rows' keys and random keys."""
    import numpy as np
    from repro_torch.core.query import requests_from_rows
    fact = cat[q.fact]
    out = []
    for i in range(n_requests):
        n = int(rng.integers(1, 9))
        if i % 2 == 0:
            out.append(requests_from_rows(
                fact, q, rng.integers(0, int(fact.nvalid), size=n)))
        else:
            out.append({a.fk_col: rng.integers(
                0, int(cat[a.table].nvalid) * 17 // 16 + 1,
                size=n).astype(np.int32) for a in q.arms})
    return out


def phase_mq_scheduler(sess, rng, card):
    """P1 and P3 runtimes on the session's admission scheduler: threaded
    interactive and batch traffic, each result bit for bit a synchronous
    ``serve`` of the same generation; then a fenced refresh under a batch
    request in flight, whose result is one generation's, whole."""
    import concurrent.futures
    import numpy as np
    import torch
    from repro_torch.core.query import compile_serving
    from repro_torch.data import QUERY_IR
    cat = sess.catalog
    runtimes = mq_runtimes(sess)
    sched = sess.scheduler(slo_ms=2.0)
    try:
        handles = {n: sched.register(rt) for n, rt in runtimes.items()}
        twins = {n: compile_serving(cat, QUERY_IR[n](), backend=b,
                                    serve_backend="kernel")
                 for n, b in MQ_CLASSES}
        work = []          # (plan name, lane, request)
        for name, _ in MQ_CLASSES:
            q = QUERY_IR[name]()
            for r in _mq_traffic(cat, q, rng, MQ_THREADS * MQ_INTERACTIVE):
                work.append((name, "interactive", r))
            work.append((name, "batch", {a.fk_col: rng.integers(
                0, int(cat[a.table].nvalid), size=MQ_BATCH_ROWS).astype(
                    np.int32) for a in q.arms}))
        order = rng.permutation(len(work))
        work = [work[i] for i in order]

        def submit(chunk):
            return [handles[n].submit(r, lane=lane) for n, lane, r in chunk]

        chunks = [[work[i] for i in idx] for idx in np.array_split(
            np.arange(len(work)), MQ_THREADS)]
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(MQ_THREADS) as ex:
            futs = [f for part in ex.map(submit, chunks) for f in part]
        results = [f.result(timeout=MQ_WAIT_S) for f in futs]
        torch.cuda.synchronize()
        traffic_s = time.perf_counter() - t0
        for (name, _, req), got in zip(work, results):
            if not same(got, twins[name].serve(req)):
                raise AssertionError(f"{name}: a scheduled result differs "
                                     "from synchronous serve")
        stats = sched.stats()
        # The fence: a batch request with keys of part rows the append
        # will add, in flight while the session refreshes.
        name, backend = MQ_CLASSES[0]
        q = QUERY_IR[name]()
        start = int(cat["part"].nvalid)
        m = int(cat["part"].nvalid) // 1000
        req = {a.fk_col: rng.integers(0, int(cat[a.table].nvalid),
                                      size=MQ_BATCH_ROWS).astype(np.int32)
               for a in q.arms}
        req["lo_partkey"][:m] = start + np.arange(m)
        want_old = twins[name].serve(req)
        fut = handles[name].submit(req, lane="batch")
        cat.append("part", part_rows(rng, start, m))
        box = {}
        fence_ms = host_ms(lambda: box.update(lines=sess.refresh()))
        got = fut.result(timeout=MQ_WAIT_S)
        new_twin = compile_serving(cat, q, backend=backend,
                                   serve_backend="kernel")
        want_new = new_twin.serve(req)
        if same(want_old, want_new):
            raise AssertionError("the append changed no answer of the "
                                 "fenced request")
        generation = ("old" if same(got, want_old) else
                      "new" if same(got, want_new) else None)
        if generation is None:
            raise AssertionError("the fenced request mixes generations")
        after = handles[name].submit(req).result(timeout=MQ_WAIT_S)
        if not same(after, want_new):
            raise AssertionError("a request after the fence is not on the "
                                 "new generation")
        plans = {n: h.name for n, h in handles.items()}
    finally:
        sched.close()
    if sched._thread.is_alive():
        raise AssertionError("the drain thread outlived close()")
    emit(phase="multiquery_scheduler", card=card, plans=plans,
         requests=len(work), threads=MQ_THREADS,
         interactive=sum(lane == "interactive" for _, lane, _ in work),
         batch=[sum(lane == "batch" for _, lane, _ in work), MQ_BATCH_ROWS],
         traffic_s=traffic_s, fence_refresh_ms=fence_ms,
         fence_lines=box["lines"], fenced_request_generation=generation,
         stats=stats,
         equal="bit for bit vs synchronous serve of one generation")
    del twins, new_twin
    torch.cuda.empty_cache()


def phase_multiquery(dev, card, sf=SF, scale=1.0):
    """Multi-query work through ``Session`` on a versioned SSB SF ``sf``
    catalog with capacity slack: the four ``multiquery_*`` phases, each
    line tagged with ``card`` (the card's name and power limit).  The
    counters are zeroed just before and read just after; both kernels
    must launch.  Returns the launches."""
    import numpy as np
    import torch
    from repro_torch.core.query import Session
    sess = Session(lifecycle_catalog(dev, sf, scale))
    rng = np.random.default_rng(4)
    reset_launches()
    phase_mq_registry(sess, card)
    phase_mq_stacked(sess, card)
    phase_mq_refresh(sess, rng, card)
    phase_mq_scheduler(sess, rng, card)
    launches = read_launches()
    emit(phase="multiquery_launches", **launches)
    for kname in ("fused_star_gather", "tree_predict"):
        if launches[kname] < 1:
            raise AssertionError(f"{kname} never launched in multi-query "
                                 "work")
    sess.evict()
    del sess
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- slice 5
SNOW_SCALE = 60               # bench_snowflake scale: 60M sales rows
SNOW_SMALL = 0.0005           # the card against the CPU (2,000 sales rows)
SNOW_STRATEGIES = ("through", "materialize", "auto")
SNOW_SERVE_ROWS = 4096        # serve vs predict_rows batch
REWRITE_SCALE = 8             # bench_rewrite scale: 8M fact rows
REWRITE_CYCLES = 3            # append → refresh() cycles
REWRITE_K = 16                # bench_rewrite's feature width and depth
REWRITE_DEPTH = 7
# The first 24 flat-arm and the first 24 chained seeds among the fuzzer's
# 0–499 (checked against the generator when the phase runs).
FUZZ_FLAT = (2, 9, 12, 14, 15, 18, 20, 21, 23, 24, 26, 27, 31, 32, 33, 34,
             35, 36, 38, 39, 40, 42, 43, 44)
FUZZ_CHAINED = (0, 1, 3, 4, 5, 6, 7, 8, 10, 11, 13, 16, 17, 19, 22, 25, 28,
                29, 30, 37, 41, 45, 49, 50)


def snowflake_build(scale, seed, dev):
    """``benchmarks/bench_snowflake.py::build``, copied with the port's
    types: fact → customer → nation → region with features on every hop, a
    predicate two hops deep (``n_f0 >= -2``), a 3×2 linear head, groups on
    ``s_g`` and ``region.r_g``; the same draws, the tables on ``dev``."""
    import numpy as np
    import torch
    from repro_torch.core.fusion import LinearOperator
    from repro_torch.core.laq import Pred, Table
    from repro_torch.core.query import (Aggregate, ArmSpec, ChainLink,
                                        GroupKey, PredictiveQuery)
    rng = np.random.default_rng(seed)
    n_fact = max(2_000, int(1_000_000 * scale))
    n_cust, n_nat, n_reg = max(n_fact // 50, 64), 256, 32
    region = Table.from_columns("region", {
        "r_pk": np.arange(n_reg), "r_g": rng.integers(0, 8, n_reg),
        "r_f0": rng.integers(-4, 5, n_reg)},
        key_cols=("r_pk", "r_g"), capacity=int(n_reg * 1.5), device=dev)
    nation = Table.from_columns("nation", {
        "n_pk": np.arange(n_nat),
        "n_to_region": rng.integers(0, int(n_reg * 1.1), n_nat),
        "n_f0": rng.integers(-4, 5, n_nat)},
        key_cols=("n_pk", "n_to_region"), capacity=int(n_nat * 1.5),
        device=dev)
    customer = Table.from_columns("customer", {
        "c_pk": np.arange(n_cust),
        "c_to_nation": rng.integers(0, int(n_nat * 1.1), n_cust),
        "c_f0": rng.integers(-4, 5, n_cust)},
        key_cols=("c_pk", "c_to_nation"), capacity=int(n_cust * 1.5),
        device=dev)
    fact = Table.from_columns("sales", {
        "fk_cust": rng.integers(0, int(n_cust * 1.1), n_fact),
        "s_g": rng.integers(0, 8, n_fact),
        "revenue": rng.integers(-4, 5, n_fact)},
        key_cols=("fk_cust", "s_g"), capacity=int(n_fact * 1.2),
        device=dev)
    arm = ArmSpec(
        "customer", "fk_cust", "c_pk", ("c_f0",), (),
        links=(ChainLink("nation", "c_to_nation", "n_pk", ("n_f0",),
                         preds=(Pred("n_f0", ">=", -2),)),
               ChainLink("region", "n_to_region", "r_pk", ("r_f0",),
                         parent="nation")))
    model = LinearOperator(torch.from_numpy(
        rng.integers(-2, 3, (3, 2)).astype(np.float32)))
    q = PredictiveQuery(
        "sales", (arm,), (), model,
        (GroupKey("fact", "s_g", 8), GroupKey("region", "r_g", 8)),
        (Aggregate("revenue", "sum", "rev"),
         Aggregate("@prediction", "sum", "p"),
         Aggregate("*", "count", "n")), 64)
    tables = {"region": region, "nation": nation, "customer": customer,
              "sales": fact}
    return tables, q


def snowflake_tree(q):
    """``q`` with a depth-3 tree (p=7, l=8, as P3's) over the chain's three
    features, every feature at some node, and a leaf histogram."""
    import dataclasses
    import numpy as np
    from repro_torch.core.fusion import tree_from_arrays
    from repro_torch.core.query import Aggregate
    tree = tree_from_arrays(np.array([0, 1, 2, 0, 1, 2, 0]),
                            np.array([0, -1, 1, 2, -2, 0, 1], np.float32), 3)
    return dataclasses.replace(q, model=tree, aggregates=(
        Aggregate("@prediction", "sum", "leaves"),
        Aggregate("*", "count", "n")))


def _same_run(got, want, what):
    """Two ``run()`` results, key for key, exactly (integer-valued data)."""
    assert set(got) == set(want), what
    for k, w in want.items():
        if not same(got[k].to(w.device), w):
            raise AssertionError(f"{what}: {k} differs")


def phase_snowflake(dev, scale=SNOW_SCALE, small=SNOW_SMALL):
    """Snowflake chains at ``bench_snowflake`` scale ``scale`` on the card.

    Per ``chain_strategy`` (through, materialize, auto) the collapse time;
    per strategy and backend (fused, nonfused) a plan whose ``run()`` must
    equal the flat ``materialize_chains`` plan bit for bit, and the same
    plans at scale ``small`` on the card and on the CPU must agree; a
    depth-3 tree over the chained features (fused and nonfused, ``"kernel"``
    against ``"torch"``, each kernel against its plain version); a nation
    append through a ``Session`` whose refresh equals a cold compile;
    stacked 3-member classes over the chain (one kernel launch per
    ``run_all``); and serving runtimes over the chain whose ``serve``
    equals ``predict_rows``.  The counters are zeroed just before and read just
    after; both kernels must launch.  Returns the launches."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.laq import Catalog, Pred
    from repro_torch.core.query import (Session, compile_query,
                                        compile_serving, materialize_chains,
                                        requests_from_rows, resolve_chain)
    from repro_torch.core.query.planner import plan_chain_materialization
    from repro_torch.core.query.snowflake import (chain_tables,
                                                  link_parents, virtual_name)

    def flat_catalog(tables, q):
        flat, flat_q = materialize_chains(tables, q)
        return Catalog({**{k: v for k, v in tables.items()
                           if k not in chain_tables(q.arms[0])},
                        **flat}), flat_q

    # The card against the CPU at a small scale, every strategy and
    # backend, the flat baseline beside them.
    cpu_t, q_small = snowflake_build(small, 0, "cpu")
    gpu_t, _ = snowflake_build(small, 0, dev)
    for qq in (q_small, snowflake_tree(q_small)):
        for backend in ("fused", "nonfused"):
            fc, fq = flat_catalog(cpu_t, qq)
            want = compile_query(fc, fq, backend=backend).run()
            for s in SNOW_STRATEGIES:
                got = compile_query(Catalog(dict(gpu_t)), qq, backend=backend,
                                    chain_strategy=s).run()
                cpu = compile_query(Catalog(dict(cpu_t)), qq,
                                    backend=backend, chain_strategy=s).run()
                _same_run(got, cpu, f"snowflake small {backend}/{s}: card "
                          "vs CPU")
                _same_run(cpu, want, f"snowflake small {backend}/{s}: chain "
                          "vs flat")
    emit(phase="snowflake_small", scale=small,
         sales_rows=int(cpu_t["sales"].nvalid), agrees_with_cpu=True,
         equals_flat=True)
    del cpu_t, gpu_t

    t0 = time.perf_counter()
    tables, q = snowflake_build(scale, 0, dev)
    torch.cuda.synchronize()
    arm = q.arms[0]
    emit(phase="snowflake_data", scale=scale,
         sales_rows=int(tables["sales"].nvalid),
         sales_capacity=tables["sales"].capacity,
         customers=int(tables["customer"].nvalid),
         nations=int(tables["nation"].nvalid),
         regions=int(tables["region"].nvalid),
         seconds=time.perf_counter() - t0,
         device_bytes=torch.cuda.memory_allocated())

    reset_launches()
    for s in SNOW_STRATEGIES:
        k, note = plan_chain_materialization(
            virtual_name(arm), [tables[p].capacity for p in link_parents(arm)],
            strategy=s, platform="cuda")
        resolve_chain(tables, arm, keep_hops=k)          # warm-up
        emit(phase="snowflake_collapse", strategy=s, keep_hops=k, note=note,
             collapse_ms=statistics.median(host_ms(
                 lambda: resolve_chain(tables, arm, keep_hops=k))
                 for _ in range(3)))

    fc, fq = flat_catalog(tables, q)
    for backend in ("fused", "nonfused"):
        flat = compile_query(fc, fq, backend=backend)
        want = {}
        flat_ms = host_ms(lambda: want.update(flat.run()))
        for s in SNOW_STRATEGIES:
            box = {}
            compile_ms = host_ms(lambda: box.update(p=compile_query(
                Catalog(dict(tables)), q, backend=backend,
                chain_strategy=s)))
            plan = box["p"]
            res = {}
            run_ms = host_ms(lambda: res.update(plan.run()))
            _same_run(res, want, f"snowflake {backend}/{s} vs flat")
            _finite_outputs(res, f"snowflake {backend}/{s}")
            emit(phase="snowflake_run", backend=backend, strategy=s,
                 serve=plan.serve_backend, compile_ms=compile_ms,
                 run_ms=run_ms, flat_run_ms=flat_ms, rows=int(res["rows"]),
                 equals_flat=True,
                 chain_note=[r for r in plan.plan.reason.split("; ")
                             if r.startswith("chain[")])
            del plan, res
        del flat, want
    del fc, fq
    torch.cuda.empty_cache()

    # A depth-3 tree over the three chained features, l = 8 as P3's.
    tq = snowflake_tree(q)
    for backend in ("fused", "nonfused"):
        plans = {sb: compile_query(Catalog(dict(tables)), tq, backend=backend,
                                   join_backend="gather", serve_backend=sb)
                 for sb in ("kernel", "torch")}
        outs, times = {}, {}
        for sb, plan in plans.items():
            res = {}
            times[f"{sb}_run_ms"] = host_ms(lambda: res.update(plan.run()))
            outs[sb] = res
        _same_run(outs["kernel"], outs["torch"], f"snowflake tree {backend}")
        checked = kernel_vs_plain_on(plans["kernel"])
        emit(phase="snowflake_tree", backend=backend, k=3, p=7, l=8,
             serve=plans["kernel"].serve_backend, kernel_equals_torch=True,
             kernel_vs_plain=checked, **times)
        del plans, outs
    torch.cuda.empty_cache()

    # A nation append through a Session: the pooled refresh equals a cold
    # compile of the appended catalog.
    rng = np.random.default_rng(1)
    cat = Catalog(dict(tables))
    sess = Session(cat)
    for qq in (q, tq):
        sess.compile(qq).run()
    m = max(1, int(tables["nation"].nvalid) // 100)
    cat.append("nation", {
        "n_pk": np.arange(m) + int(cat["nation"].nvalid),
        "n_to_region": rng.integers(0, 32, m),
        "n_f0": rng.integers(-4, 5, m)})
    snap = Catalog({k: cat[k] for k in cat})
    for label, qq in (("linear", q), ("tree", tq)):
        box = {}
        refresh_ms = host_ms(lambda: box.update(p=sess.compile(qq)))
        plan = box["p"]
        cold_box = {}
        cold_ms = host_ms(lambda: cold_box.update(p=compile_query(snap, qq)))
        cold = cold_box["p"]
        _same_run(plan.run(), cold.run(), f"snowflake refresh {label}")
        if plan.prefused is not None:
            for a, b in zip(plan.prefused.partials, cold.prefused.partials):
                assert same(a, b), f"snowflake refresh {label}: partials"
        emit(phase="snowflake_refresh", query=label, appended_nations=m,
             line=plan._refresh_notes[-1], refresh_ms=refresh_ms,
             cold_compile_ms=cold_ms, equals_cold=True,
             backend=plan.backend, serve=plan.serve_backend)
        del plan, cold

    # Stacked classes over the chain through the session: three members
    # (fact spans) per class, each class's kernel launched once a run_all.
    for label, qq, backend in (("linear", q, "fused"),
                               ("tree", tq, "nonfused")):
        members = [dataclasses.replace(qq, fact_preds=(
            Pred("revenue", ">=", lo),)) for lo in (-4, -1, 2)]
        kw = dict(backend=backend, join_backend="gather",
                  serve_backend="kernel")
        runs = [sess.compile(mq, **kw).run() for mq in members]
        box = {}
        per_call = launches_of(lambda: box.update(
            out=sess.run_all(members, **kw)))
        for got, want in zip(box["out"], runs):
            _same_run(got, want, f"snowflake stacked {label}")
        kname = "fused_star_gather" if backend == "fused" else "tree_predict"
        if per_call[kname] != 1:
            raise AssertionError(f"snowflake stacked {label}: {kname} "
                                 f"launched {per_call[kname]} times")
        emit(phase="snowflake_stacked", query=label, backend=backend,
             members=len(members), run_all_launches=per_call,
             run_all_ms=host_ms(lambda: sess.run_all(members, **kw)),
             runs_ms=sum(host_ms(lambda: sess.compile(mq, **kw).run())
                         for mq in members),
             equals_member_runs=True)
    sess.evict()
    del sess

    # Serving runtimes over the chain: serve == predict_rows.
    n_fact = int(cat["sales"].nvalid)
    ids = torch.from_numpy(rng.choice(n_fact, SNOW_SERVE_ROWS,
                                      replace=False)).to(dev)
    for label, qq, backend in (("linear", q, "fused"), ("tree", tq, "fused"),
                               ("tree", tq, "nonfused")):
        plan = compile_query(cat, qq, backend=backend, join_backend="gather",
                             serve_backend="kernel")
        rt = compile_serving(cat, qq, backend=backend, serve_backend="kernel")
        reqs = requests_from_rows(cat["sales"], qq, ids)
        got = rt.serve(reqs)
        want = plan.predict_rows(ids)
        assert same(got, want), f"snowflake serve {label}/{backend}"
        emit(phase="snowflake_serving", query=label, backend=backend,
             serve=rt.serve_backend, rows=SNOW_SERVE_ROWS,
             serve_equals_predict_rows=True,
             serve_ms=host_ms(lambda: rt.serve(reqs)))
        del plan, rt
    launches = read_launches()
    emit(phase="snowflake_launches", **launches)
    for kname in ("fused_star_gather", "tree_predict"):
        if launches[kname] < 1:
            raise AssertionError(f"{kname} never launched in the snowflake "
                                 "phase")
    del tables, cat, snap
    torch.cuda.empty_cache()
    return launches


def rewrite_build(scale, seed, dev):
    """``benchmarks/bench_rewrite.py::build`` (and its
    ``_distillable_tree``), copied with the port's types: one dimension of
    ``REWRITE_K`` features, a complete depth-``REWRITE_DEPTH`` tree whose
    all-right leaf is reachable, the filter on that (last) leaf; the same
    draws, the tables on ``dev``."""
    import numpy as np
    from repro_torch.core.fusion import tree_from_arrays
    from repro_torch.core.laq import Table
    from repro_torch.core.query import (Aggregate, ArmSpec, GroupKey,
                                        PredictionFilter, PredictiveQuery)
    rng = np.random.default_rng(seed)
    n_fact = max(2_000, int(1_000_000 * scale))
    n_dim = max(n_fact // 50, 64)
    dim_cols = {"d_pk": np.arange(n_dim)}
    for k in range(REWRITE_K):
        dim_cols[f"d_f{k}"] = rng.integers(-4, 5, n_dim)
    dim = Table.from_columns("dim", dim_cols, key_cols=("d_pk",),
                             capacity=int(n_dim * 1.5), device=dev)
    fact = Table.from_columns("fact", {
        "fk": rng.integers(0, int(n_dim * 1.1), n_fact),
        "f_g": rng.integers(0, 8, n_fact),
        "revenue": rng.integers(-4, 5, n_fact)},
        key_cols=("fk", "f_g"), capacity=int(n_fact * 1.2), device=dev)
    p = 2 ** REWRITE_DEPTH - 1
    feature = rng.integers(0, REWRITE_K, p)
    threshold = rng.integers(-3, 4, p).astype(np.float32)
    node, level = 0, 0
    while node < p:
        feature[node] = level % REWRITE_K
        threshold[node] = np.float32(-2 + (level // REWRITE_K))
        node, level = 2 * node + 2, level + 1
    model = tree_from_arrays(feature, threshold, REWRITE_K)
    arm = ArmSpec("dim", "fk", "d_pk",
                  tuple(f"d_f{k}" for k in range(REWRITE_K)), ())
    q = PredictiveQuery(
        "fact", (arm,), (), model, (GroupKey("fact", "f_g", 8),),
        (Aggregate("revenue", "sum", "rev"), Aggregate("*", "count", "n")),
        8, model_preds=(PredictionFilter(model.l - 1, "==", 1.0),))
    return {"dim": dim, "fact": fact}, q


def phase_rewrite(dev, scale=REWRITE_SCALE, cycles=REWRITE_CYCLES):
    """The rewrite engine at ``bench_rewrite`` scale ``scale`` on the card:
    the distilled ``"on"`` plan (no model) against ``"off"`` plans under
    ``"fused"`` and ``"nonfused"`` (``"kernel"``: each runs its kernel, and
    each kernel is held against its plain version) in ``run()`` and after
    each of ``cycles`` append → ``refresh()`` cycles, all bit for bit; and a
    linear query whose feature an equality pins, folded into the bias
    through ``fused_star_gather``.  The counters are zeroed just before and
    read just after; both kernels must launch.  Returns the launches."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.fusion import LinearOperator
    from repro_torch.core.laq import Catalog, Pred
    from repro_torch.core.query import (PREDICTION, Aggregate,
                                        compile_query, rewrite_query)
    t0 = time.perf_counter()
    tables, q = rewrite_build(scale, 0, dev)
    torch.cuda.synchronize()
    emit(phase="rewrite_data", scale=scale,
         fact_rows=int(tables["fact"].nvalid),
         fact_capacity=tables["fact"].capacity,
         dim_rows=int(tables["dim"].nvalid), k=REWRITE_K,
         p=int(q.model.p), l=int(q.model.l),
         seconds=time.perf_counter() - t0)
    reset_launches()
    box = {}
    pass_ms = host_ms(lambda: box.update(rw=rewrite_query(tables, q)))
    rw = box["rw"]
    assert rw.changed and rw.query.model is None, rw.trail
    plans = {"on": (Catalog(dict(tables)), None)}
    for backend in ("fused", "nonfused"):
        plans[f"off/{backend}"] = (Catalog(dict(tables)), backend)
    compiled, compile_ms = {}, {}
    for label, (cat, backend) in plans.items():
        kw = ({} if backend is None else dict(
            rewrite="off", backend=backend, join_backend="gather",
            serve_backend="kernel"))
        box = {}
        compile_ms[label] = host_ms(lambda: box.update(p=compile_query(
            cat, q, **kw)))
        compiled[label] = box["p"]
    on = compiled["on"]
    assert any("distill" in t for t in on._rewrites), on._rewrites
    assert on.query.model is None

    def check(step):
        outs, run_ms = {}, {}
        for label, plan in compiled.items():
            res = {}
            run_ms[label] = host_ms(lambda: res.update(plan.run()))
            outs[label] = res
        for label in compiled:
            if label != "on":
                _same_run(outs[label], outs["on"],
                          f"rewrite {step}: {label} vs on")
        checked = {label: kernel_vs_plain_on(plan)
                   for label, plan in compiled.items() if label != "on"}
        return run_ms, checked

    run_ms, checked = check("cold")
    emit(phase="rewrite_run", trail=list(on._rewrites),
         distilled_preds=len(on.query.arms[0].preds),
         rewrite_pass_ms=pass_ms, compile_ms=compile_ms, run_ms=run_ms,
         off_over_on={k: v / run_ms["on"] for k, v in run_ms.items()},
         on_equals_off=True, kernel_vs_plain=checked)
    rng = np.random.default_rng(2)
    n = int(tables["fact"].nvalid)
    m = max(1, n // 100)
    n_dim = int(tables["dim"].nvalid)
    for cycle in range(cycles):
        rows = {"fk": rng.integers(0, int(n_dim * 1.1), m),
                "f_g": rng.integers(0, 8, m),
                "revenue": rng.integers(-4, 5, m)}
        refresh_ms, lines = {}, {}
        for label, (cat, _) in plans.items():
            cat.append("fact", rows)
            plan = compiled[label]
            box = {}
            refresh_ms[label] = host_ms(lambda: box.update(
                line=plan.refresh()))
            lines[label] = box["line"]
        run_ms, checked = check(f"cycle {cycle}")
        emit(phase="rewrite_cycle", cycle=cycle, appended_rows=m,
             refresh_ms=refresh_ms, run_ms=run_ms, lines=lines,
             off_over_on_refresh={k: v / refresh_ms["on"]
                                  for k, v in refresh_ms.items()},
             on_equals_off=True, kernel_vs_plain=checked)
    del compiled, plans
    torch.cuda.empty_cache()

    # Constant-input folding: d_f0 pinned by an equality predicate; its L
    # row folds into the bias, which arm 0's partial carries through
    # fused_star_gather.  Per-row predictions are exact integers; the
    # grouped sums go through atomics (rtol 1e-5).
    lin_rng = np.random.default_rng(3)
    L = lin_rng.integers(-2, 3, (REWRITE_K, 2)).astype(np.float32)
    arm = dataclasses.replace(q.arms[0], preds=(Pred("d_f0", "==", 2),))
    lq = dataclasses.replace(
        q, arms=(arm,), model=LinearOperator(torch.from_numpy(L)),
        model_preds=(), aggregates=(Aggregate(PREDICTION, "sum", "p"),
                                    Aggregate("*", "count", "n")))
    kw = dict(backend="fused", join_backend="gather", serve_backend="kernel")
    lon = compile_query(Catalog(dict(tables)), lq, **kw)
    loff = compile_query(Catalog(dict(tables)), lq, rewrite="off", **kw)
    assert any("fold_constant_inputs" in t for t in lon._rewrites), \
        lon._rewrites
    assert lon.query.model.bias is not None
    pon, poff = lon.predictions(), loff.predictions()
    assert same(pon, poff), "rewrite fold: predictions on != off"
    res_on, res_off = {}, {}
    on_ms = host_ms(lambda: res_on.update(lon.run()))
    off_ms = host_ms(lambda: res_off.update(loff.run()))
    _assert_run(res_on, res_off, False, "rewrite fold run")
    emit(phase="rewrite_fold", trail=list(lon._rewrites),
         k_on=int(lon.query.model.k), k_off=int(loff.query.model.k),
         serve=lon.serve_backend, predictions_equal=True,
         run_equal=f"rtol {LINEAR_AGG_RTOL}", run_ms_on=on_ms,
         run_ms_off=off_ms, kernel_vs_plain=kernel_vs_plain_on(lon))
    del lon, loff, pon, poff
    launches = read_launches()
    emit(phase="rewrite_launches", **launches)
    for kname in ("fused_star_gather", "tree_predict"):
        if launches[kname] < 1:
            raise AssertionError(f"{kname} never launched in the rewrite "
                                 "phase")
    del tables
    torch.cuda.empty_cache()
    return launches


def phase_fuzz(dev, flat=FUZZ_FLAT, chained=FUZZ_CHAINED):
    """The port's ``check_case`` on the card (the full matrix) for the
    given seeds, plus the kernel leg: plans under ``join_backend="gather"``
    and ``serve_backend="kernel"``, fused and nonfused, against
    ``np_oracle``, and ``"kernel"`` serving runtimes against
    ``np_serving_oracle``, all bit for bit.  The counters are zeroed just
    before and read just after; both kernels must launch.  Returns the
    launches."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.laq import Catalog
    from repro_torch.core.query import (compile_query, compile_serving,
                                        requests_from_rows)
    from repro_torch.core.query.workload import (_compare, check_case,
                                                 generate_case, np_oracle,
                                                 np_serving_oracle)
    reset_launches()
    t0 = time.perf_counter()
    bad, cases = [], 0
    for seeds, chain in ((flat, False), (chained, True)):
        for seed in seeds:
            case = generate_case(seed, device=dev)
            q, tables = case.query, dict(case.tables)
            assert any(a.links for a in q.arms) == chain, seed
            bad += check_case(seed, full=True, device=dev)
            want = np_oracle(tables, q)
            for backend in ("fused", "nonfused"):
                res = compile_query(Catalog(dict(tables)), q,
                                    backend=backend, join_backend="gather",
                                    serve_backend="kernel").run()
                bad += _compare(res, want, q,
                                f"seed={seed} kernel {backend}")
            if q.model is not None and q.arms:
                qs = dataclasses.replace(q, model_preds=())
                exp = np_serving_oracle(tables, qs)
                fact = tables[q.fact]
                reqs = requests_from_rows(fact, qs,
                                          np.arange(int(fact.nvalid)))
                for backend in ("fused", "nonfused"):
                    rt = compile_serving(Catalog(dict(tables)), qs,
                                         backend=backend,
                                         serve_backend="kernel")
                    got = rt.serve(reqs).cpu().numpy().astype(np.float64)
                    if not np.array_equal(got, exp):
                        bad.append(f"seed={seed} kernel serving {backend}")
            cases += 1
    torch.cuda.synchronize()
    launches = read_launches()
    emit(phase="fuzz", cases=cases, flat=len(flat), chained=len(chained),
         legs="check_case (fused/nonfused x segment/matmul, rewrite=off, "
              "stream[16], refresh, serving) + kernel plans and runtimes",
         mismatches=len(bad), seconds=time.perf_counter() - t0)
    if bad:
        raise AssertionError("fuzz mismatches:\n" + "\n".join(bad[:10]))
    emit(phase="fuzz_launches", **launches)
    for kname in ("fused_star_gather", "tree_predict"):
        if launches[kname] < 1:
            raise AssertionError(f"{kname} never launched in the fuzz phase")
    return launches


# ------------------------------------------------------------- streaming
STREAM_CHUNKS = 7             # chunks the memory budget cuts the fact into
STREAM_PINNED_ROWS = 9_999_991  # a pinned chunk size that divides nothing
STREAM_APPEND = 0.001         # share of lineorder appended before refresh
STREAM_REPS = 3               # run_ms: median of this many runs
STREAM_PINNED = dict(backend="fused", join_backend="gather",
                     agg_backend="segment", serve_backend="kernel")


def stream_budget(cat, q):
    """A ``memory_budget_bytes`` that cuts ``q``'s fact working set (the
    planner's own per-row bytes) into ``STREAM_CHUNKS`` chunks."""
    from repro_torch.core.query.compile import _fact_row_bytes
    fact = cat[q.fact]
    out_width = q.model.l if q.model is not None else 1
    row_bytes = _fact_row_bytes(fact, q, len(q.arms), out_width)
    return fact.capacity * row_bytes // STREAM_CHUNKS


def stream_query(name):
    """The registry query ``name``; Q2.1 gets count, min and max of its
    revenue beside its sum, so the exact aggregates run too."""
    import dataclasses
    from repro_torch.core.query import Aggregate
    from repro_torch.data import QUERY_IR
    q = QUERY_IR[name]()
    if q.model is None:
        q = dataclasses.replace(q, aggregates=q.aggregates + (
            Aggregate("*", "count", "n"),
            Aggregate("lo_revenue", "min", "rev_min"),
            Aggregate("lo_revenue", "max", "rev_max")))
    return q


def stream_f64(plan, agg):
    """(float64 per-group sum, per-group sum of magnitudes) of one sum
    aggregate over the in-core plan's rows: the yardstick its float32
    sums are read against."""
    import dataclasses
    import torch
    from repro_torch.core.query import PREDICTION, eval_value
    st = plan._state
    if agg.value == PREDICTION:
        vals = plan.predictions()
    else:
        fact = dataclasses.replace(plan.star.fact, matrix=st["fact_matrix"])
        vals = torch.where(st["valid"], eval_value(fact, agg.value), 0.0)
    vals = vals.double()
    g = plan.query.num_groups
    gid = st["gid"].to(torch.int64)
    shape = (g + 1,) + tuple(vals.shape[1:])
    total = torch.zeros(shape, dtype=torch.float64, device=vals.device)
    mag = torch.zeros(shape, dtype=torch.float64, device=vals.device)
    return (total.index_add_(0, gid, vals)[:g],
            mag.index_add_(0, gid, vals.abs())[:g])


def fold_rtol(n_rows: int) -> float:
    """The tolerance of a float32 sum of ``n_rows`` values taken in
    another order: ``LINEAR_AGG_RTOL``, or ``2·sqrt(n)·2**-24`` where that
    is larger.  Each atomic add rounds by up to half an ulp of the running
    sum, so two orders of the same n adds drift apart by about
    ``sqrt(n)·2**-24`` of the sum (the streamed P1 at SF 10, 8.6M rows per
    group, differs from the in-core run by 6e-5 of it); rtol 1e-5 holds
    only up to about 7,000 rows per group."""
    return max(LINEAR_AGG_RTOL, 2.0 * n_rows ** 0.5 * 2.0 ** -24)


def stream_compare(label, got, want, q, incore, tree):
    """Hold a streamed ``run()`` against the in-core one: rows, groups,
    counts, min, max (and a tree's sums, integer-valued) exact; float sums
    at ``fold_rtol`` of the most rows any group folds (atol the same share
    of the largest magnitude), each with its error against a float64 sum
    and whether rtol 1e-5 alone held.  Returns (report, failures)."""
    import torch
    report, bad = {}, []
    ops = {a.name: a for a in q.aggregates}
    st = incore._state
    if st["gid"] is not None:
        per_group = torch.bincount(st["gid"][st["valid"]].to(torch.int64))
        n_max = int(per_group.max()) if per_group.numel() else 0
    else:
        n_max = int(st["valid"].sum())
    rtol = fold_rtol(n_max)
    for key, w in want.items():
        g = got[key].to(w.device)
        agg = ops.get(key)
        exact = (key in ("rows", "groups") or tree
                 or agg.op in ("count", "min", "max"))
        if exact:
            ok = same(g, w)
            report[key] = "exact" if ok else "differs"
        else:
            scale = float(w.abs().max().clamp(min=1.0))
            ok = bool(torch.allclose(g, w, rtol=rtol, atol=rtol * scale))
            f64, mag = stream_f64(incore, agg)
            mag_max = float(mag.max().clamp(min=1.0))
            report[key] = dict(
                within=ok, rtol=rtol, rows_per_group_max=n_max,
                rtol_1e5=bool(torch.allclose(
                    g, w, rtol=LINEAR_AGG_RTOL,
                    atol=LINEAR_AGG_RTOL * scale)),
                max_abs_diff=float((g - w).abs().max()),
                max_abs=float(w.abs().max()),
                max_rel_diff=float(((g - w).abs()
                                    / w.abs().clamp(min=1e-30)).max()),
                streamed_err_f64=float((g.double() - f64).abs().max())
                / mag_max,
                incore_err_f64=float((w.double() - f64).abs().max())
                / mag_max,
                err_unit="max |error| over max per-group sum of |value|")
        if not ok:
            bad.append(f"{label}: {key} differs from the in-core run")
    return report, bad


def chunk_copy_ms(ex):
    """Device time of one chunk's host-to-device copy (every fact-axis
    leaf of chunk 0 into chunk buffer 0, on the current stream), and its
    bytes."""
    h, b, cr = ex._host, ex._bufs[0], ex.chunk_rows
    pairs = [(b["fact_matrix"], h["fact_matrix"][:cr]),
             (b["valid"], h["valid"][:cr]), (b["ptrs"], h["ptrs"][0]),
             (b["founds"], h["founds"][0])]
    if b["gid"] is not None:
        pairs.append((b["gid"], h["gid"][:cr]))

    def copy():
        for dst, src in pairs:
            dst.copy_(src, non_blocking=True)
    nbytes = sum(src.numel() * src.element_size() for _, src in pairs)
    return time_ms(copy, reps=5, warmup=1), nbytes


def stream_case(label, cat, q, incore_res, incore, opts, tree, counts):
    """Compile ``q`` streamed under ``opts``, run it with the counters
    zeroed just before and read just after, and hold it against the
    in-core result.  Returns (plan, row, failures)."""
    import torch
    from repro_torch.core.query import compile_query
    t = time.perf_counter()
    plan = compile_query(cat, q, **opts)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t
    ex = plan._stream
    assert ex is not None, f"{label}: the plan does not stream"
    res = {}
    reset_launches()
    run_ms = host_ms(lambda: res.update(plan.run()))
    launches = read_launches()
    for k, v in launches.items():
        counts[k] += v
    want_launches = ex.n_chunks if q.model is not None else 0
    if launches["fused_star_gather"] != want_launches:
        raise AssertionError(
            f"{label}: fused_star_gather launched "
            f"{launches['fused_star_gather']} times in one run of "
            f"{ex.n_chunks} chunks (expected {want_launches})")
    runs = [run_ms] + [host_ms(plan.run) for _ in range(STREAM_REPS - 1)]
    _finite_outputs(res, label)
    report, bad = stream_compare(label, res, incore_res, q, incore, tree)
    copy_ms, copy_bytes = chunk_copy_ms(ex)
    row = dict(phase="streaming", case=label, backend=plan.backend,
               join=plan.join_backend, agg=plan.agg_backend,
               serve=plan.serve_backend, describe=ex.describe(),
               reason=next(p for p in plan.plan.reason.split("; ")
                           if p.startswith("stream=")),
               n_chunks=ex.n_chunks, chunk_rows=ex.chunk_rows,
               compile_s=compile_s, run_ms=statistics.median(runs),
               run_ms_all=runs, copy_ms_per_chunk=copy_ms,
               copy_bytes_per_chunk=copy_bytes,
               copy_gb_per_s=copy_bytes / copy_ms / 1e6,
               copy_bound_ms=copy_ms * ex.n_chunks,
               launches_per_run=launches, against_incore=report,
               host_pinned=all(t.is_pinned() for t in ex._host.values()),
               host_bytes=sum(t.numel() * t.element_size()
                              for t in ex._host.values()))
    return plan, row, bad


def phase_streaming(dev, card, sf=SF, scale=1.0):
    """Out-of-core streaming of the fact axis at SSB SF ``sf`` (see the
    module docstring, phase 12), each line tagged with ``card``.  Returns
    the launches."""
    import numpy as np
    import torch
    from repro_torch.core.fusion import DecisionTreeGEMM
    from repro_torch.core.query import compile_query
    t0 = time.perf_counter()
    cat = lifecycle_catalog(dev, sf, scale)
    torch.cuda.synchronize()
    emit(phase="streaming_data", sf=sf, scale=scale,
         lineorder_rows=int(cat["lineorder"].nvalid),
         lineorder_capacity=cat["lineorder"].capacity,
         seconds=time.perf_counter() - t0, card=card)
    counts = {k: 0 for k in kernel_wrappers()}
    bad = []
    kept = None                 # the budget-streamed P1, refreshed below
    for name in ("P1.linear.year", "P3.tree.year", "Q2.1"):
        q = stream_query(name)
        tree = isinstance(q.model, DecisionTreeGEMM)
        incore = compile_query(cat, q, **STREAM_PINNED)
        incore_res = {}
        incore_ms = [host_ms(lambda: incore_res.update(incore.run()))]
        incore_ms += [host_ms(incore.run) for _ in range(STREAM_REPS - 1)]
        budget = stream_budget(cat, q)
        cases = [(f"{name} budget", dict(memory_budget_bytes=budget,
                                         serve_backend="kernel"))]
        if name == "P1.linear.year":
            cases.append((f"{name} pinned",
                          dict(stream_chunk_rows=STREAM_PINNED_ROWS,
                               serve_backend="kernel")))
        for label, opts in cases:
            plan, row, fails = stream_case(label, cat, q, incore_res,
                                           incore, opts, tree, counts)
            if "budget" in label and plan._stream.n_chunks < 6:
                fails.append(f"{label}: {plan._stream.n_chunks} chunks")
            bad += fails
            emit(**row, budget=opts.get("memory_budget_bytes"),
                 incore_run_ms=statistics.median(incore_ms),
                 incore_run_ms_all=incore_ms, card=card)
            if kept is None:
                kept = (plan, q, opts)
            del plan
        del incore, incore_res
        torch.cuda.empty_cache()

    # Refresh in place: append 0.1 % of lineorder inside its capacity.
    plan, q, opts = kept
    ex = plan._stream
    traces, ptrs = ex.traces, {k: t.data_ptr() for k, t in ex._host.items()}
    rng = np.random.default_rng(5)
    m = int(int(cat["lineorder"].nvalid) * STREAM_APPEND)
    cat.append("lineorder", lineorder_rows(rng, cat, m))
    line = {}
    refresh_ms = host_ms(lambda: line.update(v=plan.refresh()))
    if not line["v"].startswith("refresh=delta(lineorder+1"):
        bad.append(f"streamed refresh took {line['v']!r}")
    if plan._stream is not ex or ex.traces != traces:
        bad.append("streamed refresh rebuilt the chunk buffers")
    if {k: t.data_ptr() for k, t in ex._host.items()} != ptrs:
        bad.append("streamed refresh moved the pinned host buffers")
    res = {}
    reset_launches()
    run_ms = host_ms(lambda: res.update(plan.run()))
    launches = read_launches()
    for k, v in launches.items():
        counts[k] += v
    if launches["fused_star_gather"] != ex.n_chunks:
        bad.append(f"refreshed run launched fused_star_gather "
                   f"{launches['fused_star_gather']} times, "
                   f"{ex.n_chunks} chunks")
    t = time.perf_counter()
    cold = compile_query(cat, q, **opts)
    cold_res = cold.run()
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t) * 1e3
    report, fails = stream_compare("refreshed P1", res, cold_res, q, cold,
                                   False)
    bad += fails
    emit(phase="streaming_refresh", case="P1.linear.year budget",
         appended_rows=m, line=line["v"], refresh_ms=refresh_ms,
         cold_compile_and_run_ms=cold_ms, run_ms=run_ms,
         traces=ex.traces, same_host_buffers=True,
         launches_per_run=launches, against_cold=report, card=card)
    del plan, cold, ex, cat
    torch.cuda.empty_cache()
    emit(phase="streaming_launches", **counts)
    if counts["fused_star_gather"] < 1:
        bad.append("fused_star_gather never launched in the streaming phase")
    if bad:
        raise AssertionError("streaming:\n" + "\n".join(bad))
    return counts


LM_ARCH = "smollm-360m"       # served at its full config (bf16)
LM_MOE_ARCH = "qwen2-moe-a2.7b"   # served at its full config too (bf16)
LM_RECURRENT_ARCH = "xlstm-125m"  # its recurrent decode at full width
LM_SEED = 0                   # torch.Generator seed of the LM's parameters
LM_SERVER = dict(setting=1, sf=10, k=64, l=8, scale=1.0)   # paper setting 1
LM_SWEEP = (1, 7, 8, 9, 63, 64, 65, 511, 512, 700)  # every bucket, chunked
LM_BATCHES = (4, 32)
LM_DECODE_STEPS = 8
LM_REPEATS = 10
LM_MOE_REPEATS = 8            # qwen2-moe decodes ~1.5× slower a step
LM_RECURRENT_REPEATS = 4
LM_ENTRY_REPEATS = 3          # run_serving's repeats
LM_STEP_TIMES = 5             # decode steps timed one by one (median)
LM_FP32_ATOL = 1e-3           # fp32 decode chain vs fp32 forward, logits
LM_CARD_CPU_ATOL = 1e-4       # fp32 smoke-config forward, card vs CPU
LM_ARCHS = ("qwen2-moe-a2.7b", "dbrx-132b", "jamba-1.5-large-398b",
            "xlstm-125m")     # the MoE, Mamba and xLSTM archs
LM_MOE_CUT_REPEATS = 2        # qwen2-moe at full width, 2 of 24 layers


def lm_leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in lm_leaves(v)]
    return [tree]


def lm_cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: lm_cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def lm_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in lm_leaves(params))


def top_two_gap(scores) -> float:
    top = scores.float().topk(2, dim=-1).values
    return float(top[..., 0] - top[..., 1])


def decode_chain(lm, params, tokens):
    """Logits (B, S, V) of ``tokens`` fed one by one through decode_step."""
    import torch
    batch, seq = tokens.shape
    state = lm.init_decode_state(params, batch, max_len=seq)
    out = []
    for t in range(seq):
        logits, state = lm.decode_step(params, state, tokens[:, t])
        out.append(logits)
    return torch.stack(out, 1)


def lm_step_ms(lm, params, batch, dev) -> float:
    """Median host-clock time of one decode step (each ending in a
    synchronize), after 2 warm-up steps."""
    import torch
    state = lm.init_decode_state(params, batch, max_len=LM_STEP_TIMES + 2)
    token = torch.zeros((batch,), dtype=torch.int32, device=dev)
    times = []
    for i in range(LM_STEP_TIMES + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state = lm.decode_step(params, state, token)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def lm_numerics(dev, lm, params, card):
    """The same weights decoded in bf16 and in fp32, and the fp32 decode
    chain held to the fp32 forward (``LM_FP32_ATOL``)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models import LM
    cfg = lm.cfg
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    lm32, params32 = LM(cfg32), lm_cast(params, torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, LM_DECODE_STEPS)).astype(np.int32)).to(dev)
    low = decode_chain(lm, params, tokens)
    full = decode_chain(lm32, params32, tokens)
    fwd, _ = lm32.forward(params32, tokens)
    err = max_abs_err(full, fwd)
    row = dict(
        phase="lm_numerics", arch=cfg.name, dtype=cfg.param_dtype,
        tokens=list(tokens.shape), bf16_vs_fp32_max_abs_logit=max_abs_err(
            low, full),
        bf16_vs_fp32_argmax_equal_share=float(
            (low.argmax(-1) == full.argmax(-1)).float().mean()),
        fp32_logit_max_abs=float(full.abs().max()),
        fp32_decode_vs_forward_max_abs=err,
        fp32_decode_vs_forward_atol=LM_FP32_ATOL,
        allow_bf16_reduced_precision_reduction=(
            torch.backends.cuda.matmul
            .allow_bf16_reduced_precision_reduction),
        allow_tf32=torch.backends.cuda.matmul.allow_tf32, card=card)
    emit(**row)
    del params32, low, full, fwd
    return [] if err <= LM_FP32_ATOL else [
        f"fp32 decode chain vs forward: {err} > {LM_FP32_ATOL}"]


def phase_lm_serving(dev, card, arch=LM_ARCH, cfg=None, server_opts=LM_SERVER,
                     batches=LM_BATCHES, repeats=LM_REPEATS,
                     numerics=True):
    """The LM serving path on fused features (module docstring, phases
    14–15): ``arch`` at its full config (or ``cfg``) behind
    ``FusedFeatureServer``, driven through ``launch/serve.py``'s own
    per-batch body and through ``run_serving(arch)``.  ``numerics`` adds
    the bf16 against fp32 lines (an fp32 copy of the weights must fit
    beside them).  Returns the launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.query import DEFAULT_BUCKETS
    from repro_torch.launch.serve import (FusedFeatureServer, decode_batch,
                                          run_serving)
    from repro_torch.models import LM
    t0 = time.perf_counter()
    start_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = cfg or get_config(arch)
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(LM_SEED),
                     device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    server = FusedFeatureServer(**server_opts, device=dev)
    torch.cuda.synchronize()
    fused_rt = server.runtime_fused
    emit(phase="lm_serving_setup", arch=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
         d_ff=cfg.d_ff, vocab=cfg.padded_vocab, dtype=cfg.param_dtype,
         pattern=[f"{p.mixer}/{p.mlp}" for p in cfg.pattern],
         moe=None if cfg.moe is None else dict(
             n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
             d_expert_ff=cfg.moe.d_expert_ff,
             d_shared_ff=cfg.moe.d_shared_ff),
         n_params=cfg.n_params(), param_bytes=lm_bytes(params),
         init_seconds=init_s, start_memory_allocated=start_bytes,
         init_max_memory_allocated=torch.cuda.max_memory_allocated(),
         server=server_opts, fact_rows=server.syn.n_fact,
         dim_rows=list(server.syn.dim_rows), fuse=server.decision.fuse,
         fusion_reason=server.decision.reason,
         serve_backend=fused_rt.serve_backend, buckets=fused_rt.buckets,
         seconds=time.perf_counter() - t0, card=card)
    bad = []
    if dev.type == "cuda" and fused_rt.serve_backend != "kernel":
        bad.append(f"fused runtime serves on {fused_rt.serve_backend!r}")

    # One ragged sweep over every bucket: the fused runtime against the
    # same session's plain "torch" runtime, bit for bit.
    plain = server.builder.serve(buckets=fused_rt.buckets, backend="fused",
                                 serve_backend="torch")
    rng = np.random.default_rng(1)
    for n in LM_SWEEP:
        reqs = server.random_requests(n, rng)
        if not same(server.serve_batch(reqs), plain.serve(reqs)):
            bad.append(f"fused serve of {n} requests differs from torch")
    emit(phase="lm_serving_sweep", arch=cfg.name, sizes=list(LM_SWEEP),
         kernel_equals_torch=not bad, card=card)

    # The path: decode repeats at each batch size (the first request
    # decoded twice more, fused, for a bitwise repeat), then the entry
    # point.  Every fused serve is one launch (each batch fits a bucket).
    proj = torch.from_numpy(rng.normal(
        size=(server.model.l, cfg.d_model)).astype(np.float32)).to(dev) * 0.01
    predicted = ((repeats + 1) * len(batches) + 1 + len(DEFAULT_BUCKETS)
                 + LM_ENTRY_REPEATS)
    reset_launches()
    for batch in batches:
        lat = {True: [], False: []}
        differ, unrepeatable = [], []
        for i in range(repeats):
            reqs = server.random_requests(batch, rng)
            out = {}
            for fused in (True, False):
                dt, tokens, scores = decode_batch(
                    server, lm, params, proj, reqs, batch, LM_DECODE_STEPS,
                    fused=fused)
                lat[fused].append(dt * 1e3)
                out[fused] = (tokens, scores)
            (tf, sf), (tn, sn) = out[True], out[False]
            if not torch.equal(tf, tn):
                r, s = (int(v) for v in torch.nonzero(tf != tn)[0])
                differ.append(
                    f"batch {batch} repeat {i}: fused and non-fused tokens "
                    f"differ at row {r} step {s}; top-two gaps "
                    f"{top_two_gap(sf[r, s])} (fused), "
                    f"{top_two_gap(sn[r, s])} (non-fused)")
            if i == 0:
                _, tokens2, scores2 = decode_batch(
                    server, lm, params, proj, reqs, batch, LM_DECODE_STEPS,
                    fused=True)
                if not (torch.equal(scores2, sf)
                        and torch.equal(tokens2, tf)):
                    unrepeatable.append(
                        f"batch {batch}: a second fused decode of the same "
                        f"request differs, max |Δlogit| "
                        f"{max_abs_err(scores2, sf)}")
        steady = {k: v[2:] for k, v in lat.items()}
        emit(phase="lm_serving_decode", arch=cfg.name, batch=batch,
             decode_steps=LM_DECODE_STEPS, repeats=repeats,
             fused_p50_ms=float(np.percentile(steady[True], 50)),
             fused_p99_ms=float(np.percentile(steady[True], 99)),
             nonfused_p50_ms=float(np.percentile(steady[False], 50)),
             nonfused_p99_ms=float(np.percentile(steady[False], 99)),
             fused_ms_all=lat[True], nonfused_ms_all=lat[False],
             tokens_equal=not differ,
             repeat_bitwise_equal=not unrepeatable, card=card)
        bad += differ + unrepeatable
    entry = {} if dev.type == "cuda" else {"device": dev}
    t = time.perf_counter()
    run_serving(arch, batch=4, decode_steps=LM_DECODE_STEPS, k=96, l=8,
                repeats=LM_ENTRY_REPEATS, **entry)
    entry_s = time.perf_counter() - t
    counts = read_launches()
    steps = {str(b): lm_step_ms(lm, params, b, dev) for b in batches}
    for name, rt in (("fused", fused_rt),
                     ("nonfused", server.runtime_nonfused)):
        emit(phase="lm_serving_buckets", arch=cfg.name, runtime=name,
             serve_backend=rt.serve_backend,
             latency={str(b): st for b, st in rt.latency_stats().items()},
             card=card)
    print(server.latency_report(), flush=True)
    if numerics:
        bad += lm_numerics(dev, lm, params, card)
    del params, server, plain
    torch.cuda.empty_cache()
    emit(phase="lm_serving_launches", arch=cfg.name, **counts,
         predicted_fused_star_gather=predicted,
         run_serving_arch=f"{arch} (smoke config)",
         run_serving_seconds=entry_s, decode_step_ms=steps,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         seconds=time.perf_counter() - t0, card=card)
    if counts["fused_star_gather"] != predicted:
        bad.append(f"fused_star_gather launched {counts['fused_star_gather']}"
                   f" times on the LM serving path, predicted {predicted}")
    if bad:
        raise AssertionError(f"lm_serving ({cfg.name}):\n" + "\n".join(bad))
    return counts


def lm_fp32_check(dev, cfg, label, cpu=False):
    """One fp32 arch: the decode chain against the forward on the card
    (``LM_FP32_ATOL``) and, with ``cpu``, the card's forward against the
    same parameters' forward on the CPU (``LM_CARD_CPU_ATOL``).  Returns
    the line's fields and the failures."""
    import numpy as np
    import torch
    from repro_torch.models import LM
    lm = LM(cfg)
    t0 = time.perf_counter()
    src = "cpu" if cpu else dev
    params = lm.init(torch.Generator(device=src).manual_seed(LM_SEED),
                     device=src)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, LM_DECODE_STEPS)).astype(np.int32))
    row, bad = dict(arch=cfg.name, what=label, n_layers=cfg.n_layers,
                    d_model=cfg.d_model, param_bytes=lm_bytes(params),
                    tokens=list(tokens.shape)), []
    if cpu:
        want, want_aux = lm.forward(params, tokens)
        params = lm_cast(params, dev)
    tokens = tokens.to(dev)
    fwd, aux = lm.forward(params, tokens)
    chain = decode_chain(lm, params, tokens)
    err = max_abs_err(chain, fwd)
    row.update(logit_max_abs=float(fwd.abs().max()),
               decode_vs_forward_max_abs=err,
               decode_vs_forward_atol=LM_FP32_ATOL, aux=float(aux))
    if not (err <= LM_FP32_ATOL and bool(torch.isfinite(fwd).all())):
        bad.append(f"{cfg.name} ({label}): decode chain vs forward {err}")
    if cpu:
        card_err = max_abs_err(fwd.cpu(), want)
        aux_err = abs(float(aux) - float(want_aux))
        row.update(card_vs_cpu_max_abs=card_err, card_vs_cpu_aux=aux_err,
                   card_vs_cpu_atol=LM_CARD_CPU_ATOL)
        if card_err > LM_CARD_CPU_ATOL or aux_err > LM_CARD_CPU_ATOL:
            bad.append(f"{cfg.name} ({label}): card vs CPU forward "
                       f"{card_err}, aux {aux_err}")
    row["seconds"] = time.perf_counter() - t0
    return row, bad


def phase_lm_archs(dev, card):
    """The MoE, Mamba and xLSTM archs in fp32 (module docstring, phase
    16): each smoke config's forward on the card against the CPU and its
    decode chain against its forward; qwen2-moe-a2.7b at full width cut to
    ``LM_MOE_CUT_REPEATS`` layers and xlstm-125m at full width, decode
    chain against forward.  No kernel is on this path.  Returns the
    launches."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config, get_smoke_config
    t0 = time.perf_counter()
    fp32 = dict(param_dtype="float32", compute_dtype="float32")
    bad = []
    reset_launches()
    for arch in LM_ARCHS:
        row, b = lm_fp32_check(dev, get_smoke_config(arch), "smoke config",
                               cpu=True)
        emit(phase="lm_archs", **row, card=card)
        bad += b
    for cfg, label in (
            (dataclasses.replace(get_config(LM_MOE_ARCH),
                                 n_repeats=LM_MOE_CUT_REPEATS, **fp32),
             f"full width, {LM_MOE_CUT_REPEATS} of 24 layers"),
            (dataclasses.replace(get_config(LM_RECURRENT_ARCH), **fp32),
             "full config")):
        row, b = lm_fp32_check(dev, cfg, label)
        emit(phase="lm_archs", **row, card=card)
        bad += b
        torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    for arch in ("dbrx-132b", "jamba-1.5-large-398b"):
        cfg = get_config(arch)
        emit(phase="lm_archs_full_width", arch=arch,
             bf16_param_bytes=2 * cfg.n_params(), card_bytes=total,
             run="smoke config only: the bf16 weights alone exceed one "
                 "card", card=card)
    counts = read_launches()
    emit(phase="lm_archs_launches", **counts,
         seconds=time.perf_counter() - t0, card=card)
    if any(counts.values()):
        bad.append(f"a kernel launched on the LM archs path: {counts}")
    if bad:
        raise AssertionError("lm_archs:\n" + "\n".join(bad))
    return counts


def phase_kernels_line(launches, shapes, serving_launches, onehot,
                       lifecycle_launches, multiquery_launches,
                       later_launches):
    name, ptrs, founds, partials, h = shapes["fused_star_gather"]
    g = check_gather(f"main path {name}", ptrs, founds, partials, h,
                     timing=True, library=h is None)
    name, x, tree = shapes["tree_predict"]
    t = check_tree(f"main path {name}", x.contiguous(), tree, timing=True,
                   expect_path="tensor cores")
    kernels = []
    for row, kname, line in ((g, "fused_star_gather", 53),
                             (t, "tree_predict", 34)):
        tpu = f"src/repro/kernels/{kname}/kernel.py:{line}"
        kernels.append(dict(
            name=kname, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{kname}.cu",
            replaces=tpu, tpu_source=tpu, checked=True,
            path="main path, serving, refreshed state, multi-query "
                 "work (pooled plans, stacked classes, scheduler steps), "
                 "snowflake chains, rewritten and unrewritten plans, fuzz "
                 "cases" + (", streamed chunks (one launch per chunk), LM "
                            "serving (FusedFeatureServer's fused runtime "
                            "under the decode of smollm-360m, "
                            "qwen2-moe-a2.7b and xlstm-125m)"
                            if kname == "fused_star_gather" else ""),
            launches=launches[kname],
            serving_launches=serving_launches[kname],
            lifecycle_launches=lifecycle_launches[kname],
            multiquery_launches=multiquery_launches[kname],
            **{f"{phase}_launches": counts[kname]
               for phase, counts in later_launches.items()},
            shape=row["shape"],
            max_abs_err=row["max_abs_err"], ms=row["kernel_ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], bound_rate=row["bound_rate"],
            library_ms=row["library_ms"], shape_from=row["case"]))
    row, count = onehot
    tpu = "src/repro/kernels/onehot_matmul/kernel.py:47"
    kernels.append(dict(
        name="onehot_matmul", route="cuda",
        source="src/repro_torch/kernels/csrc/onehot_matmul.cu",
        replaces=tpu, tpu_source=tpu, checked=True,
        path="none in the reference", launches=count,
        **{f"{phase}_launches": counts["onehot_matmul"]
           for phase, counts in later_launches.items()},
        shape=row["shape"],
        max_abs_err=row["max_abs_err"], ms=row["kernel_ms"],
        plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], bound_rate=row["bound_rate"],
        library_ms=row["library_ms"], shape_from=row["case"]))
    print(json.dumps({"kernels": kernels}), flush=True)


def main():
    if not (SRC / "repro_torch").is_dir():
        raise SystemExit("chip_smoke: src/repro_torch not found beside this "
                         "script; run it from a checkout of the repository")
    import torch
    card = phase_device()     # raises before any result without a card
    sys.path.insert(0, str(SRC))
    t0 = time.perf_counter()
    phase_build()
    dev = torch.device("cuda")
    phase_kernel_edges(dev)
    phase_kernel_paper(dev)
    phase_small_check(dev)
    data = phase_data(dev)
    launches, shapes, main_serving = phase_main(dev, data)
    serving_launches = phase_serving(dev, data, main_serving)
    sharding_launches = phase_sharding(dev, data, card)
    onehot = phase_onehot(dev, data)
    del data, main_serving
    torch.cuda.empty_cache()
    lifecycle_launches = phase_lifecycle(dev)
    multiquery_launches = phase_multiquery(dev, card)
    later_launches = {"sharding": sharding_launches,
                      "snowflake": phase_snowflake(dev),
                      "rewrite": phase_rewrite(dev),
                      "fuzz": phase_fuzz(dev),
                      "streaming": phase_streaming(dev, card)}
    # Each LM serving phase resets the peak to report its own: read the
    # script's peak before and after each.
    peak = torch.cuda.max_memory_allocated()
    for name, arch, repeats, numerics in (
            ("lm_serving", LM_ARCH, LM_REPEATS, True),
            ("lm_serving_moe", LM_MOE_ARCH, LM_MOE_REPEATS, False),
            ("lm_serving_recurrent", LM_RECURRENT_ARCH, LM_RECURRENT_REPEATS,
             False)):
        later_launches[name] = phase_lm_serving(
            dev, card, arch=arch, repeats=repeats, numerics=numerics)
        peak = max(peak, torch.cuda.max_memory_allocated())
    later_launches["lm_archs"] = phase_lm_archs(dev, card)
    phase_kernels_line(launches, shapes, serving_launches, onehot,
                       lifecycle_launches, multiquery_launches,
                       later_launches)
    emit(phase="done", seconds=time.perf_counter() - t0,
         max_memory_allocated=max(peak, torch.cuda.max_memory_allocated()))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
