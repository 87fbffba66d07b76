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
 12b. the command lines — ``scripts/torch_fuzz_repro.py`` and
     ``scripts/torch_memcap_proof.py`` run as a user runs them, each a
     process of its own from the repository root on the card: the fuzz
     replay (``--seed``) and ``--seed … --rewrite-matrix`` of the first flat
     and the first chained seed and an 8-case campaign (``--cases 8``), and
     the memory-cap proof (``--mode both`` at its card defaults: 60M fact
     rows, each mode uncapped and under the device-memory cap at once; the
     capped streamed child completes with the uncapped outputs bit for
     bit, the capped in-core one raises ``torch.OutOfMemoryError``).
     Every child must exit 0; each one's exit code, seconds and peak, the
     cap and the two uncapped peaks are printed.  The children print
     their kernel launches, which the kernels line adds up; both query
     kernels must launch.
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
 14. LM init — the parameters drawn with the reference's threefry PRNG
     (``repro_torch.prng``, ``LM.init(PRNGKey(0))``): smollm-360m and
     qwen2-moe-a2.7b whole at their full configs (seconds, peak memory
     beside the tree's bytes); then, in a process of its own, smollm-360m
     per shard on a one-rank ``nccl`` DeviceMesh (every local tensor equal
     to the whole draw bit for bit), and the shards of dbrx-132b and
     jamba-1.5-large-398b at full width that rank 0 and rank 511 of the
     multipod mesh (2, 16, 16) hold, drawn on the card as that rank of a
     ``fake`` group of 512 (bytes drawn, equal to the shaped DTensors'
     local bytes; seconds; peak).  Of every draw, slabs of three leaves
     are held against the CPU's draw of the same global boxes bit for
     bit: random bits, the fp32 truncated normal (``LM_INIT_ULP`` is 0)
     and the stored bf16 values (``LM_INIT_BF16_SHARE`` is 0).  The whole
     draws' seconds are printed beside those of the draw before its
     ``log1p`` and multiply-adds were XLA's (``LM_INIT_SECONDS_BEFORE``).
     No kernel may launch.
 15. LM serving — ``launch/serve.py`` on the card: smollm-360m at its full
     config (32 layers, d_model 960, 15 heads over 5 KV heads, vocab
     49152, bf16; parameters from ``LM.init(PRNGKey(0))``)
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
 16. LM serving of the MoE and recurrent archs — phase 15 again (the
     bf16-against-fp32 lines aside) for qwen2-moe-a2.7b at its full config
     (24 layers, d_model 2048, 60 experts top-4 with a 5632-wide shared
     MLP, vocab 151936, bf16: 14.3B parameters, 28.6 GB), 8 repeats, and
     for xlstm-125m at its full config (12 mLSTM/sLSTM layers, d_model
     768), 4 repeats; ``run_serving`` of each arch's smoke config.
 17. LM archs — the MoE, Mamba and xLSTM archs (qwen2-moe-a2.7b,
     dbrx-132b, jamba-1.5-large-398b, xlstm-125m) in fp32: each smoke
     config's ``forward`` on the card against the same parameters on the
     CPU (``LM_CARD_CPU_ATOL``, logits and MoE aux loss) and its decode
     chain against its forward (``LM_FP32_ATOL``); qwen2-moe-a2.7b at full
     width cut to 2 layers, and xlstm-125m at full width, decode chain
     against forward (8 tokens: no MoE pair is dropped).  dbrx-132b (263
     GB in bf16) and jamba-1.5-large-398b (797 GB) do not fit one card and
     run at their smoke configs only; a line says so.  No kernel may
     launch.
 18. LM training — ``launch/steps.py``'s ``make_train_step`` on the card:
     smollm-360m at its full config (bf16 parameters, fp32 AdamW moments,
     ``remat=True``; 361.8M parameters) for 10 steps at batch 8 and seq
     2048 (16,384 tokens a step; S > 1024 puts the flash forward and its
     FlashAttention-2 backward on the card) on ``TokenPipeline`` tokens at
     lr 3e-4.  Every loss and grad norm must be finite and the mean of the
     last three losses below step 0's by ``TRAIN_LOSS_FALL``.  After 6
     steps ``CheckpointManager.save_async`` snapshots (params, AdamW
     state, pipeline state); the run goes on, then the checkpoint is
     restored into fresh tensors (a ``meta`` target placed on the card):
     params and state bit for bit the saved ones, the restored pipeline's
     next batch the batch step 6 took, and one step from there with step
     6's loss (a forward: exact, ``TRAIN_RESUME_LOSS_RTOL``) and grad norm
     (``TRAIN_RESUME_GNORM_RTOL``: the backward adds with atomics).  ms per
     step on the host clock (each step between synchronizes), tokens/s,
     peak memory, and one step split by CUDA events into the flash
     forward, the flash backward, the loss chunks, the MLPs and AdamW
     (``scripts/torch_train_step_profile.py`` adds a ``torch.profiler``
     step: launches, device busy share).
 19. LM training of every arch — each of the ten smoke configs in fp32:
     one ``loss_and_grads`` and one ``make_train_step`` on the card against
     the same parameters and batch on the CPU (loss, every gradient, the
     grad norm, the updated parameters; ``TRAIN_*_ATOL``);
     ``flash_attention`` against ``naive_attention`` under autograd on the
     card at S = 2048 (output and dq, dk, dv), causal and not;
     qwen2-moe-a2.7b at full width cut to 2 of its 24 layers (bf16,
     1.76B parameters, fp32 moments) for 4 steps at batch 4, seq 2048:
     finite losses and grad norms, ms per step, peak memory.  Phases 18
     and 19 zero the counters and read them after: no kernel may launch.
 20. LM training on a mesh — ``launch/train.py``'s ``train()`` on
     smollm-360m at its full config, batch 8 × 2048, 3 steps with a
     checkpoint after step 2, in a process of its own: without a process
     group (plain tensors), then on a one-rank ``nccl`` group, where the
     driver places the parameters, the AdamW state and the batch as
     DTensors by ``param_shardings`` (every leaf it steps must be one);
     the three losses must equal the plain run's bit for bit.  A second
     call on the mesh resumes from the DTensor checkpoint of step 2 and a
     plain call (the group gone) restores the same checkpoint: each
     step-3 loss equals the uninterrupted one bit for bit.  Step ms
     (host clock), peak memory, ``save_async``'s blocking ms and the
     restore ms per run.  No kernel may launch.
 21. examples — ``examples/torch_{quickstart,ssb_demo,fused_serving,
     train_lm}.py`` at their defaults on the card, each a process of its
     own: exit 0 and every check line printed, seconds each; the SSB demo
     on the CPU beside them, its rows and groups equal to the card's and
     its totals within ``LINEAR_AGG_RTOL``.  Phases 20 and 21 run while
     phase 22's pod cells trace.
 22. LM dry run — ``launch/dryrun.py``, in processes of their own (a
     process has one default process group).  Three cells of the 256-card
     ``pod`` mesh (``DRYRUN_POD_CELLS``, dbrx-132b ``train_4k`` among them)
     are traced on a ``fake`` group from the start of the script, at low
     priority, beside the other phases; each prints its status, per-device
     argument/output/temp bytes and bottleneck, and must be ``ok``.  A
     one-position cell of phase 18's step (smollm-360m, batch 8 × 2048) is
     traced the same way, and the same step then runs on the card under
     ``FlopCounterMode``: the traced flops must equal the card's, and the
     predicted peak bytes are printed beside ``max_memory_allocated`` and
     their ratio.  Then the step runs again with DTensor parameters,
     optimizer state and batch on a one-rank ``nccl`` ``DeviceMesh`` (the
     activation constraints on) and must equal the plain step bit for bit.
     No kernel may launch.
 23. the kernels line (timed at the main path's shapes, and
     ``onehot_matmul`` at the SF 10 shape; launches per phase), then the
     device line.

The script imports only torch, numpy and the port.  It exits non-zero
without a result when no CUDA device is present or when ``src/repro_torch``
is missing beside it.
"""
from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
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
    from repro_torch import prng
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
        idx = prng.draw(prng.PRNGKey(d), (n,), torch.int32,
                        lambda bits: (bits % 7 - 1).to(torch.int32),
                        device=dev)
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
    given seeds, plus the kernel leg, ``check_kernels``: plans under
    ``join_backend="gather"`` and ``serve_backend="kernel"``, fused and
    nonfused, against ``np_oracle``, and ``"kernel"`` serving runtimes
    against ``np_serving_oracle``, all bit for bit.  The counters are
    zeroed just before and read just after; both kernels must launch.
    Returns the launches."""
    import torch
    from repro_torch.core.query.workload import (check_case, check_kernels,
                                                 generate_case)
    reset_launches()
    t0 = time.perf_counter()
    bad, cases = [], 0
    for seeds, chain in ((flat, False), (chained, True)):
        for seed in seeds:
            case = generate_case(seed, device=dev)
            assert any(a.links for a in case.query.arms) == chain, seed
            bad += check_case(seed, full=True, device=dev)
            bad += check_kernels(seed, device=dev)
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


# ---------------------------------------------------------- command lines
SCRIPTS_TIMEOUT_S = 600       # each command line's child
SCRIPTS_FUZZ_CASES = 8        # the fuzz command line's campaign


def _launch_lines(stdout):
    """The ``[launches]`` JSON a command line prints last, and its
    ``[peak_bytes]``."""
    launches, peak = None, None
    for line in stdout.splitlines():
        if line.startswith("[launches] "):
            launches = json.loads(line.split(" ", 1)[1])
        elif line.startswith("[peak_bytes] "):
            peak = int(line.split(" ", 1)[1])
    return launches, peak


def phase_scripts(card):
    """Phase 12b (module docstring): the fuzzer's command line and the
    memory-cap proof on the card, each child a process of its own, all at
    once.  Returns the launches the children counted."""
    t0 = time.perf_counter()
    flat, chained = str(FUZZ_FLAT[0]), str(FUZZ_CHAINED[0])
    fuzz = [["--seed", flat], ["--seed", chained],
            ["--seed", flat, "--rewrite-matrix"],
            ["--seed", chained, "--rewrite-matrix"],
            ["--cases", str(SCRIPTS_FUZZ_CASES)]]
    runs = [("torch_fuzz_repro.py", a) for a in fuzz] + [
        ("torch_memcap_proof.py", ["--mode", "both"])]
    env = {**os.environ, "PYTHONPATH": str(SRC)}

    def run(script, args):
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / script), *args],
            cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=SCRIPTS_TIMEOUT_S)
        return proc, time.perf_counter() - t

    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(runs)) as pool:
        done = list(pool.map(lambda r: run(*r), runs))
    bad, total, fuzz_total = [], {}, {}
    for (script, args), (proc, seconds) in zip(runs, done):
        launches, peak = _launch_lines(proc.stdout)
        row = dict(phase="scripts", script=f"scripts/{script}",
                   args=args, returncode=proc.returncode, seconds=seconds,
                   peak_bytes=peak, launches=launches,
                   last_lines=proc.stdout.splitlines()[-3:], card=card)
        if script == "torch_memcap_proof.py":
            proof = next((json.loads(line.split(" ", 1)[1]) for line in
                          proc.stdout.splitlines() if
                          line.startswith("[memcap] {")), {})
            row.update(cap=proof.get("cap"), cap_unit=proof.get("cap_unit"),
                       rows=proof.get("rows"),
                       uncapped_peak_bytes=proof.get("uncapped_peak_bytes"),
                       children=proof.get("children"))
        emit(**row)
        if proc.returncode != 0 or launches is None:
            bad.append(f"scripts/{script} {' '.join(args)}: exit "
                       f"{proc.returncode}\n{proc.stdout[-2000:]}"
                       f"{proc.stderr[-3000:]}")
            continue
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
            if script == "torch_fuzz_repro.py":
                fuzz_total[k] = fuzz_total.get(k, 0) + v
    emit(phase="scripts_launches", **total, fuzz=fuzz_total,
         seconds=time.perf_counter() - t0, card=card)
    if bad:
        raise AssertionError("scripts:\n" + "\n".join(bad))
    for kname in ("fused_star_gather", "tree_predict"):
        if fuzz_total.get(kname, 0) < 1:
            raise AssertionError(f"{kname} never launched in the fuzz "
                                 "command line's runs")
    return {k: total.get(k, 0) for k in kernel_wrappers()}


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
LM_SEED = 0                   # PRNGKey seed of the LM's parameters
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


# --------------------------------------------------------------- LM init ---
LM_INIT_ARCHS = (LM_ARCH, LM_MOE_ARCH)        # drawn whole at full width
LM_INIT_SHARD_ARCHS = ("dbrx-132b", "jamba-1.5-large-398b")
LM_INIT_RANKS = (0, 511)      # of the multipod mesh (2, 16, 16)
LM_INIT_SLAB_ROWS = 4         # rows of each slab held against the CPU
LM_INIT_ULP = 0               # fp32 truncated normal, card vs CPU
LM_INIT_BF16_SHARE = 0        # bf16 elements that may round apart
#: Whole-draw seconds (two runs) on an H100 80GB HBM3 at 700 W while the
#: truncated normal took torch's ``log1p`` and rounded each multiply-add
#: twice, printed beside this run's.
LM_INIT_SECONDS_BEFORE = {LM_ARCH: (1.047, 0.523),
                          LM_MOE_ARCH: (19.89, 19.88)}
LM_INIT_FLAG = "--lm-init-child"


def init_leaves_checked(described):
    """The three described leaves whose slabs are held against the CPU:
    the embedding, the largest drawn leaf and the first other drawn leaf
    of the tree's order (paths and leaves)."""
    from repro_torch.models.common import Dense
    from repro_torch.tree import flatten_with_paths
    paths, leaves = flatten_with_paths(described)
    drawn = [(p, l) for p, l in zip(paths, leaves) if isinstance(l, Dense)]
    biggest = max(drawn, key=lambda pl: math.prod(pl[1].shape))
    picked = {"embed": dict(drawn)["embed"], biggest[0]: biggest[1]}
    path, leaf = next((p, l) for p, l in drawn if p not in picked)
    picked[path] = leaf
    return list(picked.items())


def init_slab_check(dev, leaf, local, offset):
    """The first and last ``LM_INIT_SLAB_ROWS`` rows of ``local`` (the box
    of ``leaf`` at global ``offset`` drawn on the card) against the CPU's
    draw of the same global boxes: the random bits equal, the fp32
    truncated normal within ``LM_INIT_ULP`` ulp (0: equal), and the stored
    values equal save ``LM_INIT_BF16_SHARE`` of them (0), one bf16 ulp
    apart."""
    import numpy as np
    import torch
    from repro_torch import prng
    shape = tuple(local.shape)
    rows = min(LM_INIT_SLAB_ROWS, shape[-2])
    out = dict(bits_equal=True, max_ulp=0, n=0, differ=0, one_ulp=True)
    for first in (True, False):
        lo = tuple(0 if first else s - 1 for s in shape[:-2]) + (
            0 if first else shape[-2] - rows, 0)
        box = (1,) * (len(shape) - 2) + (rows, shape[-1])
        block = (tuple(o + l for o, l in zip(offset, lo)), box)
        cut = tuple(slice(l, l + b) for l, b in zip(lo, box))
        bits = [prng.random_bits(leaf.key, leaf.leaf_shape, block=block,
                                 device=d).cpu() for d in (dev, "cpu")]
        out["bits_equal"] &= torch.equal(*bits)
        tn = [prng.truncated_normal(leaf.key, -2.0, 2.0, leaf.leaf_shape,
                                    block=block, device=d).cpu().numpy()
              for d in (dev, "cpu")]
        line = [np.where(i >= 0, i, -(i & 0x7FFFFFFF)) for i in
                (t.view(np.int32).astype(np.int64) for t in tn)]
        out["max_ulp"] = max(out["max_ulp"],
                             int(np.abs(line[0] - line[1]).max()))
        card, cpu = local[cut].cpu(), leaf.draw("cpu", block=block)
        moved = card != cpu
        out["n"] += cpu.numel()
        out["differ"] += int(moved.sum())
        gap = (card.float() - cpu.float()).abs()[moved]
        out["one_ulp"] &= bool((gap <= cpu.float().abs()[moved] / 64).all())
    return out


def init_slab_failures(label, checks):
    bad = []
    for path, c in checks.items():
        if not (c["bits_equal"] and c["max_ulp"] <= LM_INIT_ULP
                and c["one_ulp"] and c["differ"] <= LM_INIT_BF16_SHARE
                * c["n"]):
            bad.append(f"{label} {path}: card vs CPU {c}")
    return bad


def lm_init_child(out_path, dev=None):
    """Phase 14's draws that need a process group, in this process of their
    own (``chip_smoke.py --lm-init-child OUT``):

    * ``one_rank``: smollm-360m at its full config drawn per shard on a
      one-rank ``nccl`` DeviceMesh (``param_shardings``) against the whole
      draw, leaf by leaf bit for bit;
    * ``multipod``: as rank 0 and rank 511 of a ``fake`` group of 512 on the
      multipod mesh (2, 16, 16), the shards of dbrx-132b and
      jamba-1.5-large-398b at full width drawn on the card: bytes, seconds,
      peak, the shaped DTensors' local bytes (which must equal the bytes
      drawn), and slabs of three leaves against the CPU.

    Writes the results to ``out_path``.  ``dev`` (default the card) may be
    the CPU for a rehearsal, with a ``gloo`` group in place of ``nccl``."""
    import gc

    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as S
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import (make_device_mesh, make_host_mesh,
                                         production_mesh_shape)
    from repro_torch.launch.sharding import param_shardings, placements
    from repro_torch.models import LM
    from repro_torch.prng import PRNGKey
    from repro_torch.tree import flatten_with_paths, leaves
    dev = torch.device("cuda", 0) if dev is None else torch.device(dev)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
    counts_before = read_launches()
    res = {}

    def timed(fn):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(seconds=time.perf_counter() - t,
                         peak_bytes=torch.cuda.max_memory_allocated()
                         - start)

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl" if on_card else "gloo",
                                init_method=f"file://{tmp}/pg", rank=0,
                                world_size=1,
                                device_id=dev if on_card else None)
        try:
            mesh = make_host_mesh(device=dev)
            model = LM(get_config(LM_ARCH))
            specs = param_shardings(S.params_shape(model), mesh,
                                    model.cfg)
            sharded, row = timed(lambda: model.init(
                PRNGKey(LM_SEED), device=dev, mesh=mesh, shardings=specs))
            whole = leaves(model.init(PRNGKey(LM_SEED), device=dev))
            shards = leaves(sharded)
            res["one_rank"] = dict(
                row, arch=LM_ARCH, mesh=list(mesh.shape), leaves=len(whole),
                bytes=sum(t.to_local().nbytes for t in shards),
                bitwise_equal=all(torch.equal(s.to_local(), w)
                                  for s, w in zip(shards, whole)))
            del sharded, whole, shards
        finally:
            dist.destroy_process_group()

    shape, axes = production_mesh_shape(multi_pod=True)
    rows = []
    for arch in LM_INIT_SHARD_ARCHS:
        model = LM(get_config(arch))
        described = model.describe(PRNGKey(LM_SEED))
        for rank in LM_INIT_RANKS:
            fake_group(math.prod(shape), rank)
            mesh = make_device_mesh(shape, axes, device_type=dev.type)
            specs = param_shardings(S.params_shape(model), mesh, model.cfg)
            paths, dleaves = flatten_with_paths(described)
            boxes = [compute_local_shape_and_global_offset(
                l.shape, mesh, placements(s, mesh))
                for l, s in zip(dleaves, leaves(specs))]
            drawn, row = timed(lambda: [t.to_local() for t in leaves(
                model.init(PRNGKey(LM_SEED), device=dev, mesh=mesh,
                           shardings=specs))])
            shaped = sum(t.to_local().nbytes
                         for t in leaves(S.shaped_params(model, mesh)))
            by_path = dict(zip(paths, zip(dleaves, drawn, boxes)))
            checks = {}
            for path, leaf in init_leaves_checked(described):
                _, local, (box, off) = by_path[path]
                checks[path] = init_slab_check(dev, leaf, local, off)
            rows.append(dict(
                row, arch=arch, rank=rank, mesh=list(shape),
                mesh_device_type=mesh.device_type,
                coordinate=mesh.get_coordinate(), leaves=len(drawn),
                bytes=sum(t.nbytes for t in drawn), shaped_bytes=shaped,
                whole_bytes=sum(math.prod(l.shape) * l.dtype.itemsize
                                for l in dleaves),
                local_shapes_equal=all(
                    tuple(t.shape) == tuple(b) for t, (b, _) in
                    zip(drawn, boxes)),
                finite=all(bool(torch.isfinite(t).all()) for t in drawn),
                slabs=checks))
            del drawn
    dist.destroy_process_group()
    res["multipod"] = rows
    res["launches"] = {k: v - counts_before[k]
                       for k, v in read_launches().items()}
    Path(out_path).write_text(json.dumps(res))


def phase_lm_init(dev, card):
    """Phase 14 (module docstring): the LM's parameters drawn with the
    reference's threefry PRNG on the card.  Returns the launches (none of
    the kernels may launch)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.prng import PRNGKey
    from repro_torch.tree import flatten_with_paths
    t0 = time.perf_counter()
    reset_launches()
    bad = []
    for arch in LM_INIT_ARCHS:
        model = LM(get_config(arch))
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        params = model.init(PRNGKey(LM_SEED), device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() - start
        by_path = dict(zip(*flatten_with_paths(params)))
        checks = {path: init_slab_check(dev, leaf, by_path[path],
                                        (0,) * len(leaf.shape))
                  for path, leaf in init_leaves_checked(
                      model.describe(PRNGKey(LM_SEED)))}
        tree_bytes = lm_bytes(params)
        emit(phase="lm_init", arch=arch, n_params=sum(
            t.numel() for t in lm_leaves(params)), tree_bytes=tree_bytes,
            seconds=seconds,
            seconds_before=LM_INIT_SECONDS_BEFORE.get(arch),
            max_memory_allocated=peak,
            peak_over_tree=peak / tree_bytes, slabs=checks, card=card)
        bad += init_slab_failures(arch, checks)
        del params, by_path
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "init.json"
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), LM_INIT_FLAG,
             str(out)], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0 or not out.exists():
            raise AssertionError("lm_init: the child failed:\n"
                                 f"{proc.stderr[-4000:]}")
        res = json.loads(out.read_text())
    one = res["one_rank"]
    emit(phase="lm_init_one_rank", **one, card=card)
    if not one["bitwise_equal"]:
        bad.append("lm_init: the one-rank nccl per-shard draw differs from "
                   "the whole draw")
    for row in res["multipod"]:
        emit(phase="lm_init_multipod", **row, card=card)
        label = f"{row['arch']} rank {row['rank']}"
        if row["bytes"] != row["shaped_bytes"] or not row[
                "local_shapes_equal"] or not row["finite"]:
            bad.append(f"lm_init: {label}: {row['bytes']} bytes drawn, "
                       f"{row['shaped_bytes']} shaped, shapes equal "
                       f"{row['local_shapes_equal']}, finite "
                       f"{row['finite']}")
        bad += init_slab_failures(f"lm_init: {label}", row["slabs"])
    counts = {k: v + res["launches"][k] for k, v in read_launches().items()}
    emit(phase="lm_init_launches", **counts,
         seconds=time.perf_counter() - t0, card=card)
    if any(counts.values()):
        bad.append(f"a kernel launched on the init path: {counts}")
    if bad:
        raise AssertionError("lm_init:\n" + "\n".join(bad))
    return counts


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
    from repro_torch.prng import PRNGKey
    t0 = time.perf_counter()
    start_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = cfg or get_config(arch)
    lm = LM(cfg)
    params = lm.init(PRNGKey(LM_SEED), device=dev)
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
    from repro_torch.prng import PRNGKey
    lm = LM(cfg)
    t0 = time.perf_counter()
    src = "cpu" if cpu else dev
    params = lm.init(PRNGKey(LM_SEED), device=src)
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


TRAIN_ARCH = "smollm-360m"    # trained at its full config (bf16, remat)
TRAIN_BATCH, TRAIN_SEQ = 8, 2048   # 16,384 tokens a step; S > 1024: flash
TRAIN_STEPS = 10
TRAIN_CKPT_AFTER = 6          # save_async after this many steps, resume
TRAIN_LOSS_FALL = 0.5         # nats: mean of the last 3 below step 0's
TRAIN_RESUME_LOSS_RTOL = 1e-6   # resumed step's loss (a forward): exact
TRAIN_RESUME_GNORM_RTOL = 1e-3  # its grad norm (the backward's atomics)
TRAIN_MOE_ARCH = LM_MOE_ARCH  # full width, 2 of its 24 layers
TRAIN_MOE_BATCH, TRAIN_MOE_STEPS = 4, 4
TRAIN_ARCH_BATCH, TRAIN_ARCH_SEQ = 2, 32   # fp32 smoke configs
TRAIN_LOSS_ATOL = 1e-4        # card vs CPU: loss, NLL
TRAIN_GRAD_ATOL = 1e-4        # card vs CPU: every gradient leaf
TRAIN_GNORM_RTOL = 1e-4       # card vs CPU: the grad norm
TRAIN_PARAM_ATOL = 1e-5       # card vs CPU: updated params where |g|≥1e-5
FLASH_SHAPE = (1, 2048, 4, 2, 32)  # B, S, H, KV, hd: flash on the card
FLASH_OUT_ATOL, FLASH_GRAD_ATOL = 2e-5, 2e-4
#: Parts of a train step timed by CUDA events around these port functions
#: (``train_step_parts``): (module, attribute).  ``_chunk_loss`` and
#: ``mlp`` hold their forward and remat recompute, not their backward.
TRAIN_PARTS = {"flash_fwd": ("repro_torch.models.attention",
                             "_flash_fwd_impl"),
               "flash_bwd": ("repro_torch.models.attention",
                             "_flash_bwd_impl"),
               "loss_chunks_fwd": ("repro_torch.launch.steps",
                                   "_chunk_loss"),
               "mlp_fwd": ("repro_torch.models.blocks", "mlp"),
               "adamw": ("repro_torch.launch.steps", "adamw_update")}


def tree_bitwise_equal(a, b) -> bool:
    import torch
    from repro_torch.tree import flatten_with_paths
    pa, la = flatten_with_paths(a)
    pb, lb = flatten_with_paths(b)
    return pa == pb and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(
            x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
            y.view(torch.int16) if y.dtype == torch.bfloat16 else y)
        for x, y in zip(la, lb))


def tree_max_abs_err(a, b) -> float:
    from repro_torch.tree import flatten_with_paths
    return max((max_abs_err(x.float(), y.float().to(x.device))
                for x, y in zip(flatten_with_paths(a)[1],
                                flatten_with_paths(b)[1])), default=0.0)


def train_batch(pipe, dev):
    import torch
    tokens, labels = pipe.next()
    return {"tokens": torch.from_numpy(tokens).to(dev),
            "labels": torch.from_numpy(labels).to(dev)}


def train_step_parts(step_fn, params, opt_state, batch):
    """Device milliseconds of one train step in each of ``TRAIN_PARTS``:
    CUDA events recorded before and after every call of the wrapped
    function (on the stream the call launches on), summed.  The wrappers
    are removed before this returns."""
    import importlib

    import torch
    marks = {name: [] for name in TRAIN_PARTS}
    saved = []

    def timed(name, fn):
        def wrapped(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            stop.record()
            marks[name].append((start, stop))
            return out
        return wrapped

    for name, (mod, attr) in TRAIN_PARTS.items():
        module = importlib.import_module(mod)
        saved.append((module, attr, getattr(module, attr)))
        setattr(module, attr, timed(name, getattr(module, attr)))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for module, attr, fn in saved:
            setattr(module, attr, fn)
    parts = {name: sum(s.elapsed_time(e) for s, e in m)
             for name, m in marks.items()}
    calls = {name: len(m) for name, m in marks.items()}
    return step_ms, parts, calls


def phase_lm_train(dev, card):
    """smollm-360m trained at its full config (module docstring, phase
    17): ``TRAIN_STEPS`` steps of ``make_train_step`` on ``TokenPipeline``
    tokens; a ``save_async`` after ``TRAIN_CKPT_AFTER`` steps restored into
    fresh tensors and resumed; one step timed by parts.  No kernel is on
    this path.  Returns the launches."""
    import gc
    import tempfile

    import numpy as np
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline, TokenPipelineConfig
    from repro_torch.launch.steps import make_train_step, params_shape
    from repro_torch.models import LM
    from repro_torch.prng import PRNGKey
    from repro_torch.optim import AdamWConfig, adamw_init
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    start_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(TRAIN_ARCH)
    lm = LM(cfg)
    params = lm.init(PRNGKey(LM_SEED), device=dev)
    opt_cfg = AdamWConfig()
    opt = adamw_init(params, opt_cfg)
    step_fn = make_train_step(lm, cfg, opt_cfg)
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, global_batch=TRAIN_BATCH,
        seq_len=TRAIN_SEQ), process_index=0, process_count=1)
    emit(phase="lm_train_setup", arch=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, n_heads=cfg.n_heads,
         n_kv_heads=cfg.n_kv_heads, vocab=cfg.padded_vocab,
         dtype=cfg.param_dtype, remat=cfg.remat, n_params=cfg.n_params(),
         param_bytes=lm_bytes(params), moment_bytes=lm_bytes(opt.m) * 2,
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=opt_cfg.lr,
         start_memory_allocated=start_bytes, card=card)
    reset_launches()
    losses, gnorms, times = [], [], []
    bad = []
    with tempfile.TemporaryDirectory() as ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep=2)
        for step in range(TRAIN_STEPS):
            if step == TRAIN_CKPT_AFTER:
                torch.cuda.synchronize()
                t = time.perf_counter()
                mgr.save_async(step, (params, opt),
                               extras={"pipeline": pipe.state()})
                save_block_ms = (time.perf_counter() - t) * 1e3
                saved = (params, opt)
            batch = train_batch(pipe, dev)
            if step == TRAIN_CKPT_AFTER:
                saved_batch = batch
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            losses.append(float(metrics["loss"]))
            gnorms.append(float(metrics["grad_norm"]))
            if step == TRAIN_CKPT_AFTER:
                uninterrupted = params
        counts = read_launches()
        peak = torch.cuda.max_memory_allocated()
        t = time.perf_counter()
        mgr.wait()
        wait_ms = (time.perf_counter() - t) * 1e3
        ckpt_bytes = sum(p.stat().st_size
                         for p in Path(ckpt_dir).rglob("*") if p.is_file())
        # Restore into fresh tensors (a meta target placed on the card).
        shapes = params_shape(lm)
        t = time.perf_counter()
        (rp, ro), extras = mgr.restore(
            TRAIN_CKPT_AFTER, (shapes, adamw_init(shapes, opt_cfg)),
            sharding_fn=lambda path: dev)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t) * 1e3
    restored_equal = tree_bitwise_equal((rp, ro), saved)
    pipe2 = TokenPipeline(pipe.cfg, process_index=0, process_count=1)
    pipe2.restore(extras["pipeline"])
    batch2 = train_batch(pipe2, dev)
    batch_equal = all(torch.equal(batch2[k], saved_batch[k])
                      for k in batch2)
    rp2, _, m2 = step_fn(rp, ro, batch2)
    resumed_loss, resumed_gnorm = float(m2["loss"]), float(m2["grad_norm"])
    want_loss = losses[TRAIN_CKPT_AFTER]
    want_gnorm = gnorms[TRAIN_CKPT_AFTER]
    resumed_param_err = tree_max_abs_err(rp2, uninterrupted)
    del saved, rp, ro, rp2, uninterrupted, saved_batch
    steady = times[1:]
    step_ms = statistics.median(steady)
    emit(phase="lm_train", arch=cfg.name, steps=TRAIN_STEPS,
         losses=losses, grad_norms=gnorms, step_ms_all=times,
         step_ms=step_ms, tokens_per_s=TRAIN_BATCH * TRAIN_SEQ
         / (step_ms / 1e3), first_step_ms=times[0],
         loss_fall=losses[0] - float(np.mean(losses[-3:])),
         loss_fall_margin=TRAIN_LOSS_FALL,
         max_memory_allocated=peak, card=card)
    emit(phase="lm_train_checkpoint", arch=cfg.name,
         saved_after_steps=TRAIN_CKPT_AFTER, checkpoint_bytes=ckpt_bytes,
         save_async_block_ms=save_block_ms, wait_ms=wait_ms,
         restore_ms=restore_ms, restored_bitwise_equal=restored_equal,
         pipeline_state=extras["pipeline"], batch_bitwise_equal=batch_equal,
         resumed_loss=resumed_loss, uninterrupted_loss=want_loss,
         resumed_loss_rtol=TRAIN_RESUME_LOSS_RTOL,
         resumed_grad_norm=resumed_gnorm,
         uninterrupted_grad_norm=want_gnorm,
         resumed_grad_norm_rtol=TRAIN_RESUME_GNORM_RTOL,
         resumed_params_max_abs_diff=resumed_param_err, card=card)
    batch = train_batch(pipe, dev)
    part_step_ms, parts, calls = train_step_parts(step_fn, params, opt,
                                                  batch)
    emit(phase="lm_train_parts", arch=cfg.name,
         timed_step_host_ms=part_step_ms, part_device_ms=parts,
         part_share=({k: v / part_step_ms for k, v in parts.items()}),
         part_calls=calls, card=card)
    if not all(np.isfinite(losses + gnorms)):
        bad.append(f"non-finite loss or grad norm: {losses} {gnorms}")
    if not float(np.mean(losses[-3:])) < losses[0] - TRAIN_LOSS_FALL:
        bad.append(f"loss fell {losses[0] - float(np.mean(losses[-3:]))}"
                   f" nats, under the margin {TRAIN_LOSS_FALL}")
    if not (restored_equal and batch_equal):
        bad.append("restored checkpoint or pipeline differs from the saved")
    if abs(resumed_loss - want_loss) > TRAIN_RESUME_LOSS_RTOL * abs(
            want_loss):
        bad.append(f"resumed loss {resumed_loss} vs {want_loss}")
    if abs(resumed_gnorm - want_gnorm) > TRAIN_RESUME_GNORM_RTOL * abs(
            want_gnorm):
        bad.append(f"resumed grad norm {resumed_gnorm} vs {want_gnorm}")
    del params, opt, batch, batch2
    gc.collect()                  # the autograd graphs' reference cycles
    torch.cuda.empty_cache()
    emit(phase="lm_train_launches", **counts,
         seconds=time.perf_counter() - t0, card=card)
    if any(counts.values()):
        bad.append(f"a kernel launched on the training path: {counts}")
    if bad:
        raise AssertionError("lm_train:\n" + "\n".join(bad))
    return counts


def train_arch_check(dev, arch):
    """One fp32 smoke-config train step of ``arch`` on the card and on the
    CPU from the same parameters and batch: losses, gradients, grad norm
    and updated parameters compared.  Returns the line and the failures."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import (loss_and_grads, make_loss_fn,
                                          make_train_step)
    from repro_torch.models import LM
    from repro_torch.prng import PRNGKey
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.tree import flatten_with_paths
    t0 = time.perf_counter()
    cfg = get_smoke_config(arch)
    lm = LM(cfg)
    opt_cfg = AdamWConfig()
    params = lm.init(PRNGKey(LM_SEED), device="cpu")
    rng = np.random.default_rng(5)
    b, s = TRAIN_ARCH_BATCH, TRAIN_ARCH_SEQ
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
             "labels": rng.integers(0, cfg.vocab_size, (b, s))}
    batch = {k: torch.from_numpy(v.astype(np.int32))
             for k, v in batch.items()}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.normal(
            size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32))
    out = {}
    for where in ("cpu", dev):
        p = lm_cast(params, where)
        bt = {k: v.to(where) for k, v in batch.items()}
        tot, nll, grads = loss_and_grads(make_loss_fn(lm, cfg), p, bt)
        p2, _, m = make_train_step(lm, cfg, opt_cfg)(
            p, adamw_init(p, opt_cfg), bt)
        out[str(where)] = (float(tot), float(nll), grads, p2, m)
    (ctot, cnll, cg, cp, cm), (gtot, gnll, gg, gp, gm) = \
        out["cpu"], out[str(dev)]
    grad_err = tree_max_abs_err(gg, cg)
    want_gnorm = float(cm["grad_norm"])
    gnorm_rel = abs(float(gm["grad_norm"]) - want_gnorm) / want_gnorm
    param_err = all_err = 0.0
    for g, x, y in zip(flatten_with_paths(cg)[1], flatten_with_paths(cp)[1],
                       flatten_with_paths(gp)[1]):
        err = (y.cpu() - x).abs()
        all_err = max(all_err, float(err.max()))
        well = g.abs() >= 1e-5
        if bool(well.any()):
            param_err = max(param_err, float(err[well].max()))
    finite = all(bool(torch.isfinite(t).all())
                 for t in flatten_with_paths(gg)[1])
    row = dict(arch=cfg.name, batch=b, seq=s, loss_card=gtot, loss_cpu=ctot,
               loss_abs_diff=abs(gtot - ctot),
               nll_abs_diff=abs(gnll - cnll), grad_max_abs_diff=grad_err,
               grad_norm_card=float(gm["grad_norm"]),
               grad_norm_rel_diff=gnorm_rel,
               updated_param_max_abs_diff=param_err,
               updated_param_max_abs_diff_all=all_err,
               seconds=time.perf_counter() - t0)
    bad = []
    if not (finite and np.isfinite(gtot)):
        bad.append(f"{arch}: non-finite loss or gradients on the card")
    if (abs(gtot - ctot) > TRAIN_LOSS_ATOL
            or abs(gnll - cnll) > TRAIN_LOSS_ATOL
            or grad_err > TRAIN_GRAD_ATOL or gnorm_rel > TRAIN_GNORM_RTOL
            or param_err > TRAIN_PARAM_ATOL or all_err > 2 * opt_cfg.lr):
        bad.append(f"{arch}: card vs CPU train step {row}")
    return row, bad


def flash_check(dev, causal):
    """``flash_attention`` against ``naive_attention`` under autograd on
    the card at ``FLASH_SHAPE``: outputs and (dq, dk, dv)."""
    import numpy as np
    import torch
    from repro_torch.models.attention import (flash_attention,
                                              naive_attention)
    b, s, h, kv, hd = FLASH_SHAPE
    rng = np.random.default_rng(6)
    arrays = [rng.normal(size=shape).astype(np.float32)
              for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))]
    w = torch.from_numpy(rng.normal(size=(h * hd,)).astype(np.float32)).to(
        dev)
    res = []
    for fn in (flash_attention, naive_attention):
        ts = [torch.from_numpy(a).to(dev).requires_grad_(True)
              for a in arrays]
        out = fn(*ts, causal=causal)
        (out.reshape(b, s, -1) * w).sum().backward()
        res.append((out.detach().reshape(b, s, -1), [t.grad for t in ts]))
    (fo, fg), (no, ng) = res
    out_err = max_abs_err(fo, no)
    grad_err = max(max_abs_err(x, y) for x, y in zip(fg, ng))
    row = dict(what="flash vs naive", shape=list(FLASH_SHAPE),
               causal=causal, out_max_abs_diff=out_err,
               grad_max_abs_diff=grad_err, out_atol=FLASH_OUT_ATOL,
               grad_atol=FLASH_GRAD_ATOL)
    ok = out_err <= FLASH_OUT_ATOL and grad_err <= FLASH_GRAD_ATOL
    return row, [] if ok else [f"flash vs naive on the card: {row}"]


def phase_lm_train_archs(dev, card):
    """Every arch's train step on the card (module docstring, phase 19):
    the ten smoke configs in fp32 against the CPU, the flash attention's
    forward and backward against naive attention at S = 2048, and
    qwen2-moe-a2.7b at full width cut to 2 layers for ``TRAIN_MOE_STEPS``
    steps.  No kernel is on this path.  Returns the launches."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import arch_ids, get_config
    from repro_torch.data import TokenPipeline, TokenPipelineConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import LM
    from repro_torch.prng import PRNGKey
    from repro_torch.optim import AdamWConfig, adamw_init
    t0 = time.perf_counter()
    bad = []
    reset_launches()
    for arch in arch_ids():
        row, b = train_arch_check(dev, arch)
        emit(phase="lm_train_archs", **row, card=card)
        bad += b
    for causal in (True, False):
        row, b = flash_check(dev, causal)
        emit(phase="lm_train_archs", **row, card=card)
        bad += b
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(TRAIN_MOE_ARCH),
                              n_repeats=LM_MOE_CUT_REPEATS)
    lm = LM(cfg)
    params = lm.init(PRNGKey(LM_SEED), device=dev)
    opt_cfg = AdamWConfig()
    opt = adamw_init(params, opt_cfg)
    state_bytes = lm_bytes(params) + 2 * lm_bytes(opt.m)
    step_fn = make_train_step(lm, cfg, opt_cfg)
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, global_batch=TRAIN_MOE_BATCH,
        seq_len=TRAIN_SEQ), process_index=0, process_count=1)
    losses, gnorms, times = [], [], []
    for _ in range(TRAIN_MOE_STEPS):
        batch = train_batch(pipe, dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    step_ms = statistics.median(times[1:])
    emit(phase="lm_train_archs", arch=cfg.name,
         what=f"full width, {LM_MOE_CUT_REPEATS} of 24 layers",
         n_params=cfg.n_params(), param_bytes=lm_bytes(params),
         state_bytes=state_bytes, dtype=cfg.param_dtype, remat=cfg.remat,
         batch=TRAIN_MOE_BATCH, seq=TRAIN_SEQ, losses=losses,
         grad_norms=gnorms, step_ms_all=times, step_ms=step_ms,
         tokens_per_s=TRAIN_MOE_BATCH * TRAIN_SEQ / (step_ms / 1e3),
         max_memory_allocated=torch.cuda.max_memory_allocated(), card=card)
    if not all(np.isfinite(losses + gnorms)):
        bad.append(f"{cfg.name}: non-finite loss or grad norm {losses} "
                   f"{gnorms}")
    del params, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    counts = read_launches()
    emit(phase="lm_train_archs_launches", **counts,
         memory_allocated_after=torch.cuda.memory_allocated(),
         seconds=time.perf_counter() - t0, card=card)
    if any(counts.values()):
        bad.append(f"a kernel launched on the train archs path: {counts}")
    if bad:
        raise AssertionError("lm_train_archs:\n" + "\n".join(bad))
    return counts


# --------------------------------------------------------------- dry run ---
#: Cells of the production ``pod`` mesh the script dry-runs, beside the
#: other phases: (arch, shape).
DRYRUN_POD_CELLS = (("dbrx-132b", "train_4k"), ("smollm-360m", "train_4k"),
                    ("qwen2-moe-a2.7b", "decode_32k"))
DRYRUN_POD_TIMEOUT_S = 840    # from the cells' start, for all three
DRYRUN_ONE_SHAPE = "lm_train_8x2048"   # phase 18's step, one position
DRYRUN_CHILD_FLAG = "--lm-dryrun-child"


class DryrunCells:
    """The ``DRYRUN_POD_CELLS`` dry runs, one ``python -m
    repro_torch.launch.dryrun`` process each at low priority, started when
    this is made; ``records()`` waits for them, ``stop()`` ends any still
    running."""

    def __init__(self):
        self.dir = tempfile.TemporaryDirectory()
        self.t0 = time.perf_counter()
        env = {**os.environ, "PYTHONPATH": str(SRC)}
        self.procs = []
        for arch, shape in DRYRUN_POD_CELLS:
            with open(self._log(arch, shape), "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--shape", shape, "--mesh", "pod",
                     "--outdir", self.dir.name], env=env, stdout=log,
                    stderr=subprocess.STDOUT,
                    preexec_fn=lambda: os.nice(10)))

    def _log(self, arch, shape) -> Path:
        return Path(self.dir.name) / f"{arch}__{shape}.log"

    def records(self):
        out = []
        for (arch, shape), proc in zip(DRYRUN_POD_CELLS, self.procs):
            left = DRYRUN_POD_TIMEOUT_S - (time.perf_counter() - self.t0)
            try:
                proc.wait(timeout=max(left, 1))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                out.append({"arch": arch, "shape": shape, "status": "failed",
                            "error": f"not done in {DRYRUN_POD_TIMEOUT_S} s"})
                continue
            path = Path(self.dir.name) / f"{arch}__{shape}__pod.json"
            if path.exists():
                out.append(json.loads(path.read_text()))
            else:
                out.append({"arch": arch, "shape": shape, "status": "failed",
                            "error": self._log(arch, shape).read_text()[
                                -2000:]})
        return out, time.perf_counter() - self.t0

    def stop(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        self.dir.cleanup()


def lm_dryrun_child(out_path):
    """Phase 22's one-position checks, in this process of their own (run
    as ``chip_smoke.py --lm-dryrun-child OUT``): the dry run of phase 18's
    step on a one-rank fake group, the step on the card (its peak memory,
    then its flops in a second run under ``FlopCounterMode``), and the
    step with DTensors on a one-rank ``nccl`` mesh against the plain
    one.  Writes the results to ``out_path``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import dp_axes, make_device_mesh
    from repro_torch.launch.sharding import (P, distribute_tree,
                                             param_shardings)
    from repro_torch.models import LM
    from repro_torch.prng import PRNGKey
    from repro_torch.models.act_sharding import (clear_activation_sharding,
                                                 set_activation_sharding)
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.tree import tree_map
    S.SHAPES[DRYRUN_ONE_SHAPE] = dict(kind="train", seq=TRAIN_SEQ,
                                      batch=TRAIN_BATCH)
    cfg = get_config(TRAIN_ARCH)
    res = {}
    D.fake_group(1)
    mesh = make_device_mesh((1, 1), ("data", "model"))
    t = time.perf_counter()
    _, costs, mem, global_flops = D.trace_cell(cfg, DRYRUN_ONE_SHAPE, mesh)
    res.update(trace_s=time.perf_counter() - t, flops=costs.flops,
               global_flops=global_flops, mem_bytes=costs.mem_bytes,
               n_collectives=costs.n_collectives,
               argument_bytes=mem.argument_bytes,
               predicted_peak_bytes=mem.peak_bytes,
               temp_bytes=mem.temp_bytes)
    dist.destroy_process_group()

    dev = torch.device("cuda")
    lm = LM(cfg)
    params = lm.init(PRNGKey(LM_SEED), device=dev)
    opt_cfg = AdamWConfig()
    opt = adamw_init(params, opt_cfg)
    rng = np.random.default_rng(LM_SEED)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)).to(dev)
        for k in ("tokens", "labels")}
    step_fn = S.make_train_step(lm, cfg, opt_cfg)
    counts_before = read_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    want = step_fn(params, opt, batch)
    torch.cuda.synchronize()
    res.update(step_s=time.perf_counter() - t,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               loss=float(want[2]["loss"]))
    # A dispatch mode changes how some ops are decomposed (the last bits
    # of a few gradients): the flops come from a step of their own.
    with FlopCounterMode(display=False) as counter:
        step_fn(params, opt, batch)
    res["card_flops"] = float(counter.get_total_flops())

    with tempfile.TemporaryDirectory() as store:
        dist.init_process_group("nccl", init_method=f"file://{store}/pg",
                                rank=0, world_size=1)
        try:
            mesh = make_device_mesh((1, 1), ("data", "model"))
            specs = param_shardings(params, mesh, cfg)
            dparams = distribute_tree(params, specs, mesh)
            dopt = AdamWState(step=distribute_tree(opt.step, P(), mesh),
                              m=distribute_tree(opt.m, specs, mesh),
                              v=distribute_tree(opt.v, specs, mesh))
            dbatch = distribute_tree(
                batch, {k: P(dp_axes(mesh), None) for k in batch}, mesh)
            set_activation_sharding(dp_axes(mesh), "model", mesh)
            try:
                got = step_fn(dparams, dopt, dbatch)
            finally:
                clear_activation_sharding()
            got = tree_map(lambda x: x.full_tensor()
                           if hasattr(x, "full_tensor") else x, got)
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    res.update(dtensor_bitwise_equal=tree_bitwise_equal(got, want),
               dtensor_max_abs_diff=tree_max_abs_err(got, want),
               launches={k: v - counts_before[k]
                         for k, v in read_launches().items()})
    Path(out_path).write_text(json.dumps(res))


def phase_lm_dryrun(card, cells):
    """Phase 22 (module docstring): the one-position checks in a child
    process, then the pod cells ``cells`` (a ``DryrunCells``) started at
    the beginning.  Returns the launches (the child's counters)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "one.json"
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             DRYRUN_CHILD_FLAG, str(out)], capture_output=True, text=True,
            timeout=900)
        if proc.returncode != 0 or not out.exists():
            raise AssertionError("lm_dryrun: the one-position child failed:"
                                 f"\n{proc.stderr[-4000:]}")
        one = json.loads(out.read_text())
    emit(phase="lm_dryrun_one", arch=TRAIN_ARCH, batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, mesh=[1, 1], trace_s=one["trace_s"],
         step_s=one["step_s"],
         dryrun_flops=one["flops"], dryrun_global_flops=one["global_flops"],
         card_flops=one["card_flops"],
         flops_equal=one["flops"] == one["card_flops"],
         dryrun_mem_bytes=one["mem_bytes"],
         argument_bytes=one["argument_bytes"],
         predicted_peak_bytes=one["predicted_peak_bytes"],
         max_memory_allocated=one["max_memory_allocated"],
         peak_ratio=one["predicted_peak_bytes"]
         / one["max_memory_allocated"],
         loss=one["loss"],
         dtensor_bitwise_equal=one["dtensor_bitwise_equal"],
         dtensor_max_abs_diff=one["dtensor_max_abs_diff"], card=card)
    records, waited = cells.records()
    bad = []
    for rec in records:
        roof = rec.get("roofline", {})
        emit(phase="lm_dryrun_cell", arch=rec["arch"], shape=rec["shape"],
             mesh="pod", status=rec["status"],
             trace_s=rec.get("compile_s"), memory=rec.get("memory"),
             flops_per_dev=roof.get("flops_per_dev"),
             mem_bytes_per_dev=roof.get("mem_bytes_per_dev"),
             coll_bytes_per_dev=roof.get("coll_bytes_per_dev"),
             bottleneck=roof.get("bottleneck"),
             flop_counter=rec.get("flop_counter"),
             error=rec.get("error"), card=card)
        if rec["status"] != "ok":
            bad.append(f"{rec['arch']} {rec['shape']}: {rec['status']} "
                       f"{rec.get('error', '')}")
    counts = one["launches"]
    emit(phase="lm_dryrun_launches", **counts, pod_cells_s=waited,
         seconds=time.perf_counter() - t0, card=card)
    if one["flops"] != one["card_flops"]:
        bad.append(f"dry-run flops {one['flops']} != the card's "
                   f"{one['card_flops']}")
    if not one["dtensor_bitwise_equal"]:
        bad.append("the DTensor step on a one-rank nccl mesh differs from "
                   f"the plain step by {one['dtensor_max_abs_diff']}")
    if any(counts.values()):
        bad.append(f"a kernel launched on the dry-run path: {counts}")
    if bad:
        raise AssertionError("lm_dryrun:\n" + "\n".join(bad))
    return counts


# ------------------------------------------------- training on a mesh ---
TRAIN_MESH_STEPS = 3          # each run of the driver (phase 20)
TRAIN_MESH_CKPT_EVERY = 2     # one checkpoint, after step 2
TRAIN_MESH_FLAG = "--lm-train-mesh-child"


def lm_train_mesh_child(out_path):
    """Phase 20's runs of ``launch.train.train``, in this process of their
    own (run as ``chip_smoke.py --lm-train-mesh-child OUT``), since they
    start a process group: smollm-360m at its full config, batch
    ``TRAIN_BATCH`` × ``TRAIN_SEQ``, ``TRAIN_MESH_STEPS`` steps with a
    checkpoint after step ``TRAIN_MESH_CKPT_EVERY``:

    * ``plain``: no process group (the driver's plain tensors);
    * ``mesh``: the same call on a one-rank ``nccl`` group, so the driver
      places the parameters, the AdamW state and the batch as DTensors by
      ``param_shardings``;
    * ``mesh_resumed``: the same call again, resuming from ``mesh``'s
      checkpoint of step 2 (its last step only);
    * ``plain_from_mesh``: with the group gone, the plain driver resuming
      from that DTensor checkpoint.

    The driver's ``CheckpointManager`` and ``StragglerMonitor`` are
    wrapped to read the save's blocking ms, the restore ms and the step
    times (host clock, each step ending in a synchronize), and its train
    step to count the DTensor leaves it is given.  Writes the results to
    ``out_path``."""
    import gc

    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train as T
    from repro_torch.runtime import StragglerMonitor
    from repro_torch.tree import leaves
    rec = {}

    class TimedManager(CheckpointManager):
        def save_async(self, *args, **kwargs):
            t = time.perf_counter()
            super().save_async(*args, **kwargs)
            rec["save_block_ms"].append((time.perf_counter() - t) * 1e3)

        def restore(self, *args, **kwargs):
            t = time.perf_counter()
            out = super().restore(*args, **kwargs)
            torch.cuda.synchronize()
            rec["restore_ms"].append((time.perf_counter() - t) * 1e3)
            return out

    class StepTimes(StragglerMonitor):
        def record_step(self, times):
            rec["step_ms"].extend(v * 1e3 for v in times.values())
            return super().record_step(times)

    make_train_step = T.S.make_train_step

    def counting_train_step(*args, **kwargs):
        step_fn = make_train_step(*args, **kwargs)

        def step(params, opt, batch):
            if "dtensor_leaves" not in rec:
                rec["dtensor_leaves"] = {
                    name: [sum(isinstance(x, DTensor) for x in leaves(t)),
                           len(leaves(t))]
                    for name, t in (("params", params), ("opt_state", opt),
                                    ("batch", batch))}
            return step_fn(params, opt, batch)
        return step

    T.CheckpointManager, T.StragglerMonitor = TimedManager, StepTimes
    T.S.make_train_step = counting_train_step
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    counts_before = read_launches()
    runs = {}

    def run(name, ckpt_dir):
        rec.clear()
        rec.update(step_ms=[], save_block_ms=[], restore_ms=[])
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        losses = T.train(TRAIN_ARCH, smoke=False, steps=TRAIN_MESH_STEPS,
                         batch=TRAIN_BATCH, seq=TRAIN_SEQ, ckpt_dir=ckpt_dir,
                         ckpt_every=TRAIN_MESH_CKPT_EVERY, log_every=1,
                         device=dev)
        runs[name] = dict(rec, losses=losses,
                          seconds=time.perf_counter() - t,
                          max_memory_allocated=torch.cuda
                          .max_memory_allocated())

    with tempfile.TemporaryDirectory() as tmp:
        run("plain", f"{tmp}/plain")
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                                rank=0, world_size=1, device_id=dev)
        try:
            run("mesh", f"{tmp}/mesh")
            run("mesh_resumed", f"{tmp}/mesh")
        finally:
            dist.destroy_process_group()
        step_dir = Path(tmp) / "mesh" / f"step_{TRAIN_MESH_CKPT_EVERY:08d}"
        layout = sorted(p.name for p in step_dir.iterdir())
        ckpt_bytes = sum(p.stat().st_size for p in step_dir.iterdir())
        run("plain_from_mesh", f"{tmp}/mesh")
    Path(out_path).write_text(json.dumps(dict(
        runs=runs, checkpoint_layout=layout, checkpoint_bytes=ckpt_bytes,
        launches={k: v - counts_before[k]
                  for k, v in read_launches().items()})))


def phase_lm_train_mesh(card):
    """Phase 20 (module docstring): the training driver on a one-rank
    ``nccl`` DeviceMesh against the plain driver, in a child process.
    Returns the launches (the child's counters)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "mesh.json"
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), TRAIN_MESH_FLAG,
             str(out)], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0 or not out.exists():
            raise AssertionError("lm_train_mesh: the child failed:\n"
                                 f"{proc.stderr[-4000:]}")
        res = json.loads(out.read_text())
    runs = res["runs"]
    for name, r in runs.items():
        steady = r["step_ms"][1:] or r["step_ms"]
        emit(phase="lm_train_mesh", run=name, arch=TRAIN_ARCH,
             batch=TRAIN_BATCH, seq=TRAIN_SEQ,
             mesh=[1, 1] if name.startswith("mesh") else None,
             dtensor_leaves=r.get("dtensor_leaves"), losses=r["losses"],
             step_ms_all=r["step_ms"], step_ms=statistics.median(steady),
             save_async_block_ms=r["save_block_ms"],
             restore_ms=r["restore_ms"],
             max_memory_allocated=r["max_memory_allocated"],
             seconds=r["seconds"], card=card)
    plain, mesh = runs["plain"]["losses"], runs["mesh"]["losses"]
    last = mesh[-1:]
    checks = dict(
        mesh_equals_plain=mesh == plain,
        resumed_equals_uninterrupted=runs["mesh_resumed"]["losses"] == last,
        plain_from_mesh_equals=runs["plain_from_mesh"]["losses"] == last,
        finite=all(map(math.isfinite, plain + mesh)))
    counts = res["launches"]
    emit(phase="lm_train_mesh_checks", **checks, plain_losses=plain,
         mesh_losses=mesh, resumed_loss=runs["mesh_resumed"]["losses"],
         plain_from_mesh_loss=runs["plain_from_mesh"]["losses"],
         checkpoint_layout=res["checkpoint_layout"],
         checkpoint_bytes=res["checkpoint_bytes"], card=card)
    emit(phase="lm_train_mesh_launches", **counts,
         seconds=time.perf_counter() - t0, card=card)
    bad = [name for name, ok in checks.items() if not ok]
    for name in ("mesh", "mesh_resumed"):
        n = runs[name]["dtensor_leaves"]
        if any(k != total for k, total in n.values()):
            bad.append(f"{name}: not every leaf is a DTensor: {n}")
    if any(k for k, _ in runs["plain"]["dtensor_leaves"].values()):
        bad.append("plain: a DTensor leaf without a process group")
    if len(plain) != TRAIN_MESH_STEPS or len(last) != 1:
        bad.append(f"steps run: {plain} {mesh}")
    if res["checkpoint_layout"] != ["COMMITTED", "host_0000.npz",
                                    "meta.json"]:
        bad.append(f"checkpoint layout {res['checkpoint_layout']}")
    if any(counts.values()):
        bad.append(f"a kernel launched on the training path: {counts}")
    if bad:
        raise AssertionError("lm_train_mesh:\n" + "\n".join(bad))
    return counts


# ------------------------------------------------------------- examples ---
#: The port's examples (``examples/``) at their defaults, each with the
#: lines it must print.
EXAMPLES = (
    ("torch_quickstart.py", (
        "segment == matmul aggregation ✓",
        "fused == non-fused row predictions ✓",
        "sharded == single-device ✓ on mesh {'data': 2, 'model': 4}",
        "append → refresh ≡ cold rebuild ✓", "scheduled serving ✓",
        "run_all over 4 variants ✓", "evict → pool drained ✓",
        "streamed == in-core bitwise ✓", "snowflake ✓",
        "sub-dimension append → chain refresh ≡ cold rebuild ✓",
        "rewrite ✓ distill")),
    ("torch_ssb_demo.py", ("Q1.1: rows=", "P4.tree.select.region: rows=",
                           "Q2.1 head: year")),
    ("torch_fused_serving.py", ("[serve] fusion planner: fuse=True",
                                "[serve] batch=4 decode=8 fused p50=")),
    ("torch_train_lm.py", ("(improved)", "[train] resumed from step 200",
                           "resumed and ran 10 more steps")),
)


def _query_lines(stdout):
    """The SSB demo's per-query lines as {name: (rows, groups, total)}."""
    line_re = re.compile(r"^(\S+): rows=\s*(\d+) +(?:groups=\s*(\d+) +)?"
                         r"\w+_total=(\S+)")
    return {m[1]: (m[2], m[3], float(m[4]))
            for m in map(line_re.match, stdout.splitlines()) if m}


def phase_examples(card):
    """Phase 21 (module docstring): each of ``EXAMPLES`` run on the card as
    a user runs it, in a process of its own, one after another, with the
    SSB demo on the CPU beside them, whose query lines must be the
    card's."""
    t0 = time.perf_counter()
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        env = {**os.environ, "PYTHONPATH": str(SRC), "TMPDIR": tmp}
        cpu_demo = subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / "torch_ssb_demo.py"),
             "--device", "cpu"], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        outs = {}
        for name, lines in EXAMPLES:
            t = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, str(ROOT / "examples" / name)], env=env,
                capture_output=True, text=True, timeout=600)
            seconds = time.perf_counter() - t
            out = proc.stdout.splitlines()
            missing = [want for want in lines
                       if not any(want in line for line in out)]
            outs[name] = proc.stdout
            emit(phase="examples", example=name, device="cuda",
                 returncode=proc.returncode, seconds=seconds,
                 checks=len(lines), missing=missing, last_lines=out[-3:],
                 card=card)
            if proc.returncode != 0 or missing:
                bad.append(f"{name}: exit {proc.returncode}, missing "
                           f"{missing}\n{proc.stderr[-2000:]}")
        cpu_stdout, _ = cpu_demo.communicate(timeout=600)
    card_lines = _query_lines(outs["torch_ssb_demo.py"])
    cpu_lines = _query_lines(cpu_stdout)
    # Rows and groups exact; totals to LINEAR_AGG_RTOL (float sums on the
    # card add with atomics).
    same = (cpu_demo.returncode == 0 and len(cpu_lines) > 0
            and card_lines.keys() == cpu_lines.keys() and all(
                card_lines[q][:2] == cpu_lines[q][:2]
                and abs(card_lines[q][2] - cpu_lines[q][2])
                <= LINEAR_AGG_RTOL * abs(cpu_lines[q][2])
                for q in cpu_lines))
    emit(phase="examples_ssb_card_vs_cpu", queries=len(card_lines),
         rows_groups_totals_agree=same, totals_rtol=LINEAR_AGG_RTOL,
         seconds=time.perf_counter() - t0, card=card)
    if not same:
        bad.append(f"torch_ssb_demo.py: the card's query lines differ from "
                   f"the CPU's:\n{card_lines}\n{cpu_lines}")
    if bad:
        raise AssertionError("examples:\n" + "\n".join(bad))


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
    cells = DryrunCells()         # traced on the host beside the phases
    try:
        run_phases(card, t0, cells)
    finally:
        cells.stop()


def run_phases(card, t0, cells):
    import torch
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
                      "fuzz": phase_fuzz(dev)}
    torch.cuda.empty_cache()
    later_launches["scripts"] = phase_scripts(card)
    later_launches["streaming"] = phase_streaming(dev, card)
    # Each LM serving phase resets the peak to report its own: read the
    # script's peak before and after each.
    later_launches["lm_init"] = phase_lm_init(dev, card)
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
    later_launches["lm_train"] = phase_lm_train(dev, card)
    peak = max(peak, torch.cuda.max_memory_allocated())
    later_launches["lm_train_archs"] = phase_lm_train_archs(dev, card)
    torch.cuda.empty_cache()
    # These two run while the dry run's pod cells are still tracing on
    # the host; the dry-run phase then waits for what is left of them.
    later_launches["lm_train_mesh"] = phase_lm_train_mesh(card)
    phase_examples(card)
    later_launches["lm_dryrun"] = phase_lm_dryrun(card, cells)
    phase_kernels_line(launches, shapes, serving_launches, onehot,
                       lifecycle_launches, multiquery_launches,
                       later_launches)
    emit(phase="done", seconds=time.perf_counter() - t0,
         max_memory_allocated=max(peak, torch.cuda.max_memory_allocated()))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == [DRYRUN_CHILD_FLAG]:
        lm_dryrun_child(sys.argv[2])
    elif sys.argv[1:2] == [TRAIN_MESH_FLAG]:
        lm_train_mesh_child(sys.argv[2])
    elif sys.argv[1:2] == [LM_INIT_FLAG]:
        lm_init_child(sys.argv[2])
    else:
        main()
