"""LM token data pipeline: deterministic, sharded, checkpointable (port of
``repro.data.tokens``).

* A synthetic corpus (seeded Zipf mixture — stable statistics across
  hosts) stands in for tokenized shards; swap ``ZipfCorpus`` for a
  file-backed reader on a real cluster (same iterator contract).  It
  stays numpy, drawn from ``np.random.default_rng((seed, step, row))``,
  so both packages give the same tokens bit for bit.
* Each host reads only its slice of the global batch (disjoint by the
  ``torch.distributed`` rank when it is initialised, or by the position
  the caller names: the training driver passes each rank's position
  along the mesh's data axes, so ranks of one model group read the same
  rows).
* Iterator state = (seed, step) — restoring a checkpoint replays the
  pipeline to the exact batch boundary (fault-tolerance requirement).
* A background prefetch thread keeps ``prefetch`` batches ahead of the
  step.

``make_global_batch`` assembles the global batch from this process's
slice: on a ``DeviceMesh`` a DTensor whose local shard is the slice
(``DTensor.from_local``, no collective), the counterpart of the
reference's ``make_array_from_process_local_data``; on a single-process
``Mesh`` one tensor on the mesh's first device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class TokenPipelineConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    prefetch: int = 2


def _process_index_count() -> Tuple[int, int]:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class ZipfCorpus:
    """Deterministic synthetic token stream (Zipf-ish unigram mixture)."""

    def __init__(self, vocab_size: int, seed: int):
        self.vocab_size = vocab_size
        self.seed = seed

    def batch(self, step: int, rows: int, seq_len: int,
              row_offset: int) -> np.ndarray:
        # Independent per (step, row) streams → any host can regenerate any
        # slice; this is what makes elastic re-sharding trivial.
        out = np.empty((rows, seq_len + 1), np.int32)
        for r in range(rows):
            rng = np.random.default_rng(
                (self.seed, step, row_offset + r))
            u = rng.random(seq_len + 1)
            out[r] = (self.vocab_size ** u - 1).astype(np.int32) % \
                self.vocab_size
        return out


class TokenPipeline:
    """Checkpointable iterator of (tokens, labels) host-local slices."""

    def __init__(self, cfg: TokenPipelineConfig,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.cfg = cfg
        pi, pc = _process_index_count()
        self.pi = pi if process_index is None else process_index
        self.pc = pc if process_count is None else process_count
        if cfg.global_batch % self.pc:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {self.pc} processes")
        self.rows_per_host = cfg.global_batch // self.pc
        self.corpus = ZipfCorpus(cfg.vocab_size, cfg.seed)
        self.step = 0
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ---- iterator state (checkpointed) ------------------------------------
    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def restore(self, state: dict):
        self.stop()
        self.step = int(state["step"])

    # ---- production --------------------------------------------------------
    def _make(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        raw = self.corpus.batch(step, self.rows_per_host, self.cfg.seq_len,
                                row_offset=self.pi * self.rows_per_host)
        return raw[:, :-1], raw[:, 1:]

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self._make(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def start(self):
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def stop(self):
        """Stop the prefetch thread and drop what it made.  The queue is
        drained after the join: the reference drains it first, so a
        ``put`` the drain unblocks can leave a stale batch queued, and a
        pipeline restarted after ``restore`` then hands out that batch."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=2.0)
            if self._thread.is_alive():
                raise RuntimeError("token prefetch thread did not stop")
            while not self._q.empty():
                self._q.get_nowait()
            self._thread = None

    def next(self) -> Tuple[np.ndarray, np.ndarray]:
        """Host-local (tokens, labels) for the current step (prefetched)."""
        if self._thread is None:
            batch = self._make(self.step)
            self.step += 1
            return batch
        step, batch = self._q.get()
        if step != self.step:
            raise RuntimeError(f"prefetched step {step}, expected "
                               f"{self.step}")
        self.step += 1
        return batch


def make_global_batch(local_tokens: np.ndarray, mesh, pspec):
    """The global batch from this process's slice of it.

    On a ``DeviceMesh``: a DTensor placed by ``pspec`` (the batch dim over
    the data axes, every other mesh dim replicated) whose local shard is
    ``local_tokens``, this rank's rows; the slices go in order of the
    data position (``launch.mesh.dp_position``), so the full tensor is
    the rows of the one-process pipeline for the same step.  On a
    single-process ``Mesh``: one tensor on the mesh's first device
    (``pspec`` names its split, which one process does not place).
    """
    local = torch.as_tensor(np.asarray(local_tokens))
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        return local.to(mesh.devices.reshape(-1)[0])
    from ..launch.mesh import dp_position
    from ..launch.sharding import from_local, placements
    _, count = dp_position(mesh)
    return from_local(local, mesh, placements(pspec, mesh),
                      (local.shape[0] * count, *local.shape[1:]))
