"""A profiled slice of the window, reduced to what the per-layer metrics
read: device busy seconds, kernel launches, the device operations that
took most time and the idle gaps by what the host was doing.

The loop labels its work with ``record_function`` ranges: ``query:<name>``
around ``run()``, ``copy:<name>`` around the copy to the host, ``loop``
around a round, and ``window`` around the whole slice.  An idle gap takes
the name of the innermost range that holds its middle.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import tempfile
import time
from typing import List, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class Slice:
    """Profiles from ``begin()`` to ``end(queries)``; ``stats`` after
    ``finish()``."""

    def __init__(self, device: torch.device, seconds: float):
        self.device = device
        self.seconds = seconds
        self.active = False
        self.stats: Optional[dict] = None
        self._prof = self._window = None
        self._t0 = 0.0
        self._queries = 0

    def begin(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._window = torch.profiler.record_function("window")
        self._window.__enter__()
        self.active = True
        self._t0 = time.perf_counter()

    def due(self) -> bool:
        return self.active and time.perf_counter() - self._t0 >= self.seconds

    def end(self, queries: int) -> None:
        """Stop profiling; ``finish()`` reduces the trace once the window
        has closed."""
        self._window.__exit__(None, None, None)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.__exit__(None, None, None)
        self.active = False
        self._queries = queries

    def finish(self) -> None:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self._prof = None
        self.stats = summarize(events, self._queries)

    def label(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)


def _union(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: List[dict], queries: int) -> dict:
    """Reduce a Chrome trace of one slice (times in microseconds)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("cat") == "user_annotation"
           and e.get("name") == "window"]
    if not win:
        raise ValueError("the trace holds no 'window' range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = []
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if b > w0 and a < w1:
            dev.append((max(a, w0), min(b, w1), e["name"], e["cat"]))
    busy = _union([(a, b) for a, b, _, _ in dev])
    ops = collections.Counter()
    for a, b, name, _ in dev:
        ops[name] += b - a
    # Outer ranges first among those that start together, so that the
    # latest-starting range that holds a time is the innermost.
    ranges = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["name"]) for e in xs
                     if e.get("cat") == "user_annotation"
                     and e.get("name") != "window"),
                    key=lambda r: (r[0], -r[1]))
    starts = [r[0] for r in ranges]
    idle = collections.Counter()
    edge = w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            idle[_innermost(ranges, starts, (edge + a) / 2)] += a - edge
        edge = max(edge, b)
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "kernels": sum(1 for _, _, _, cat in dev if cat == "kernel"),
        "queries": queries,
        "device_ops": [[n, s * 1e-6] for n, s in ops.most_common(TOP)],
        "idle_gaps": [[n, s * 1e-6] for n, s in idle.most_common(TOP)],
    }


def _innermost(ranges, starts, t: float) -> str:
    """The latest-starting labelled range that holds time ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        a, b, name = ranges[i]
        if a <= t <= b:
            return name
        i -= 1
    return "other"
