"""Serving driver: the paper's predictive pipeline, end to end (port of
``repro.launch.serve``).

Requests carry one foreign key per star arm (they are *not* fact-row ids —
any incoming key tuple is servable).  The request path:

  1. **Dynamic-batch LAQ + operator fusion** (the paper's contribution):
     per-request feature vectors are produced by the *pre-fused* star
     pipeline — Σⱼ Iⱼ(Bⱼ Mⱼ L) — through ``compile_serving``: one plan per
     padding bucket, PK lookups + gathers + adds, no join materialization,
     no separate ML runtime (paper Eq. 1 / §3.2).  On the card the fused
     runtime's gather-add is the ``fused_star_gather`` kernel.
  2. Optionally, an LM consumes the fused features as a conditioning
     vector (soft-prompt added to the first token's logits) and decodes a
     fixed number of tokens with KV caches, eagerly.

Runs on the card unless given ``device="cpu"``; with no card and no
``device`` it raises.  Reports per-bucket serve-latency percentiles plus
per-batch end-to-end percentiles for fused vs non-fused execution — the
paper's speedup, measured end to end.

The reference's ``interpret`` option (Pallas interpret mode) has no
counterpart here: a kernel wrapper given CPU tensors runs the kernel's
plain version.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_smoke_config
from ..core.fusion import LinearOperator
from ..core.query import (DEFAULT_BUCKETS, Catalog, Session,
                          query_from_star, requests_from_rows)
from ..data import generate_star
from ..device import DeviceLike, resolve_device
from ..models import LM
from ..prng import PRNGKey


class FusedFeatureServer:
    """The paper's pipeline as a serving component.

    One :class:`~repro_torch.core.query.Session` binds the synthetic star
    catalog (and the optional serving mesh) and hands out two dynamic-batch
    serving runtimes (fused and non-fused reference) from one fluent
    pipeline.  Requests are batches of per-arm foreign keys served through
    ``ServingRuntime.serve`` — on the fused plan that is one PK lookup +
    gather-add per arm per batch (paper Eq. 1), padded into a fixed set of
    shape buckets.  The star and the linear head come from the reference's
    numpy draws, so one seed serves the same weights in both packages.
    """

    def __init__(self, setting: int, sf: float, k: int, l: int,
                 scale: float = 1.0, seed: int = 0,
                 buckets=DEFAULT_BUCKETS, serve_backend: str = "auto",
                 mesh=None, shard_threshold_bytes=None,
                 device: DeviceLike = None):
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        self.syn = generate_star(setting, sf, k, seed=seed, scale=scale,
                                 device=dev)
        self.model = LinearOperator(
            torch.from_numpy(rng.normal(size=(k, l)).astype(np.float32)))
        tables, self.query = query_from_star(self.syn.star,
                                             model=self.model)
        # Mutable versioned catalog: dimension appends flow through to the
        # live runtimes via ``append_dim`` without restarting the server.
        self.catalog = Catalog(tables)
        self.mesh = mesh
        self.session = Session(self.catalog, mesh=mesh,
                               shard_threshold_bytes=shard_threshold_bytes)
        self.builder = self.session.bind(self.query)
        self.runtime_fused = self.builder.serve(
            buckets=buckets, backend="fused", serve_backend=serve_backend)
        self.runtime_nonfused = self.builder.serve(
            buckets=buckets, backend="nonfused",
            serve_backend=serve_backend)
        self.decision = self.runtime_fused.plan.fusion
        self._scheduled = {}

    def runtime(self, fused: bool = True):
        return self.runtime_fused if fused else self.runtime_nonfused

    def scheduled(self, fused: bool = True, **scheduler_opts):
        """The async serving handle for one runtime (lazy registration).

        Registers the runtime on the session's admission scheduler
        (created on first use with ``scheduler_opts`` — ``slo_ms``,
        ``max_queued_rows``, ...) and returns its ``ScheduledPlan``; use
        ``submit_batch`` for the Future-based request path under
        concurrent open-loop traffic.  The scheduler's drain thread runs
        until ``self.session.scheduler().close()``.
        """
        if fused not in self._scheduled:
            sched = self.session.scheduler(**scheduler_opts)
            self._scheduled[fused] = sched.register(
                self.runtime(fused), name="fused" if fused else "nonfused")
        return self._scheduled[fused]

    def append_dim(self, table: str, rows) -> dict:
        """Append dimension rows and refresh both live runtimes in place.

        ``catalog.append`` bumps the table's version; each runtime applies
        the delta path (extend the PK index, prefuse only the new rows)
        while the rows fit the table's padded capacity, and newly appended
        keys become servable immediately.  A runtime serving through the
        admission scheduler is refreshed behind its drain-then-swap fence,
        so in-flight scheduled batches complete on the old state first.
        Returns the per-runtime refresh decisions.
        """
        self.catalog.append(table, rows)
        return {"fused": self.session._refresh_runtime(self.runtime_fused),
                "nonfused":
                    self.session._refresh_runtime(self.runtime_nonfused)}

    def serve_batch(self, requests, fused: bool = True):
        """Predictions for a batch of per-arm FK requests (any size)."""
        return self.runtime(fused).serve(requests)

    def submit_batch(self, requests, fused: bool = True,
                     lane: str = "interactive"):
        """Async request path: enqueue on the scheduler, get a Future."""
        return self.scheduled(fused).submit(requests, lane=lane)

    def serve_rows(self, row_ids, fused: bool = True):
        """Bridge from the old interface: serve the FKs of fact rows."""
        reqs = requests_from_rows(self.syn.star.fact, self.query, row_ids)
        return self.serve_batch(reqs, fused=fused)

    def random_requests(self, n: int, rng: np.random.Generator):
        """A request batch sampled from the dimension key ranges."""
        reqs = {}
        for arm, rows in zip(self.query.arms, self.syn.dim_rows):
            # ~1/16 of keys miss the dimension: exercises not-found masking.
            keys = rng.integers(0, max(int(rows * 17 / 16), 1), size=n)
            reqs[arm.fk_col] = keys.astype(np.int32)
        return reqs

    def latency_report(self) -> str:
        lines = []
        for name, rt in (("fused", self.runtime_fused),
                         ("nonfused", self.runtime_nonfused)):
            for bucket, st in rt.latency_stats().items():
                compile_ms = st.get("compile_ms")
                extra = (f" compile={compile_ms:.0f}ms"
                         if compile_ms is not None else "")
                pcts = (f"p50={st['p50']:.2f}ms p95={st['p95']:.2f}ms "
                        f"p99={st['p99']:.2f}ms" if st["count"]
                        else "(no steady-state samples)")
                lines.append(f"[serve] {name} bucket={bucket} "
                             f"n={st['count']} {pcts}{extra}")
            lines.append(f"[serve] {name} compiles={rt.num_compiles} "
                         f"(buckets={rt.buckets})")
        for fused, plan in self._scheduled.items():
            st = plan.stats()
            for lane, lt in st["lanes"].items():
                pcts = (f"p50={lt['p50']:.2f}ms p99={lt['p99']:.2f}ms"
                        if lt["count"] else "(no completed requests)")
                lines.append(f"[sched] {plan.name} lane={lane} "
                             f"n={lt['count']} {pcts}")
            lines.append(f"[sched] {plan.name} steps={st['steps']} "
                         f"admitted={st['admitted_rows']} "
                         f"padded={st['padded_rows']} "
                         f"rejected={st['rejected']}")
        return "\n".join(lines)


def decode_batch(server: FusedFeatureServer, lm: LM, params,
                 proj: torch.Tensor, requests, batch: int,
                 decode_steps: int, fused: bool = True):
    """One timed request batch of :func:`run_serving`: serve the features,
    project them to a soft prompt, decode ``decode_steps`` tokens.

    The soft prompt ``cond @ head`` (fp32 features times the head matrix
    cast to fp32) is added to each step's logits before the argmax; it is
    the same every step, so it is computed once.  The clock stops after
    the device has finished.  Returns ``(seconds, tokens, scores)``:
    ``tokens`` (batch, decode_steps) are the argmaxes, ``scores`` (batch,
    decode_steps, padded_vocab) fp32 the biased logits each was read from.
    """
    dev = proj.device
    t0 = time.perf_counter()
    feats = server.serve_batch(requests, fused=fused)  # (batch, l)
    cond = feats @ proj                                # (batch, d_model)
    state = lm.init_decode_state(params, batch, max_len=decode_steps + 1)
    token = torch.zeros((batch,), dtype=torch.int32, device=dev)
    # Soft-prompt injection: the conditioning vector biases the logits of
    # every step after a first decode of token 0.
    logits, state = lm.decode_step(params, state, token)
    bias = cond @ lm.head_matrix(params).to(cond.dtype)
    out, scores = [], []
    for _ in range(decode_steps):
        score = logits + bias
        token = torch.argmax(score, dim=-1)
        logits, state = lm.decode_step(params, state, token.to(torch.int32))
        out.append(token)
        scores.append(score)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0, torch.stack(out, 1),
            torch.stack(scores, 1))


def run_serving(arch: str, batch: int, decode_steps: int, k: int, l: int,
                repeats: int = 20, device: DeviceLike = None):
    dev = resolve_device(device)
    cfg = get_smoke_config(arch)
    lm = LM(cfg)
    params = lm.init(PRNGKey(0), device=dev)
    server = FusedFeatureServer(setting=2, sf=1, k=k, l=min(l, cfg.d_model),
                                scale=0.05, device=dev)
    print(f"[serve] fusion planner: fuse={server.decision.fuse} "
          f"({server.decision.reason})")
    print(f"[serve] serving plan: backend={server.runtime_fused.backend} "
          f"serve_backend={server.runtime_fused.serve_backend} "
          f"buckets={server.runtime_fused.buckets}")

    rng = np.random.default_rng(1)
    # Ragged warm-up sweep: hit every padding bucket once, so the steady
    # state below has each bucket's first call behind it.
    for n in [1] + [b for b in server.runtime_fused.buckets]:
        reqs = server.random_requests(n, rng)
        server.serve_batch(reqs, fused=True)
        server.serve_batch(reqs, fused=False)

    # Conditioning projection: fused features → d_model soft prompt.
    proj = torch.from_numpy(rng.normal(
        size=(server.model.l, cfg.d_model)).astype(np.float32)).to(dev) * 0.01

    lat_fused, lat_non = [], []
    for _ in range(repeats):
        requests = server.random_requests(batch, rng)
        dt, tokens_fused, _ = decode_batch(server, lm, params, proj,
                                           requests, batch, decode_steps,
                                           fused=True)
        lat_fused.append(dt)
        dt, tokens_non, _ = decode_batch(server, lm, params, proj, requests,
                                         batch, decode_steps, fused=False)
        lat_non.append(dt)
        # Identical tokens either way (fusion is exact — paper Eq. 1).
        np.testing.assert_array_equal(tokens_fused.cpu().numpy(),
                                      tokens_non.cpu().numpy())

    def pct(a, p):
        return float(np.percentile(np.asarray(a[2:]) * 1e3, p))

    print(f"[serve] batch={batch} decode={decode_steps} "
          f"fused p50={pct(lat_fused,50):.1f}ms p99={pct(lat_fused,99):.1f}ms"
          f" | non-fused p50={pct(lat_non,50):.1f}ms "
          f"p99={pct(lat_non,99):.1f}ms")
    print(server.latency_report())
    return lat_fused, lat_non


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--l", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    run_serving(args.arch, args.batch, args.decode_steps, args.k, args.l,
                args.repeats, device=args.device)


if __name__ == "__main__":
    main()
