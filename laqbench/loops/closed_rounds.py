"""One client in a closed loop: the analyst's or dashboard's query stream.

The client runs rounds; each round is a permutation of the traffic's
queries drawn from the seed, and the next query starts when the previous
one's aggregates, ``groups`` and ``rows`` are on the host.  Whole rounds
run until the window's seconds are up, so every run holds the same mix.
"""
from __future__ import annotations

import contextlib
import random
import time
from typing import Dict, List, Optional, Tuple


def _to_host(out):
    return {k: v.cpu() for k, v in out.items()}


def warm(plans: Dict[str, object], traffic: dict) -> None:
    """Run every query of the traffic ``warmup_rounds`` times."""
    for _ in range(traffic["warmup_rounds"]):
        for name in traffic["queries"]:
            _to_host(plans[name].run())


def drive(plans: Dict[str, object], traffic: dict, seed: int,
          seconds: float, clock, tracer=None) -> dict:
    """The window: per query its name, clock marks and host answer (None
    where ``run()`` raised), the host seconds from the first query's start
    to the last one's end, and each query's end in those seconds.
    ``tracer`` profiles the first whole rounds until its seconds are
    up."""
    rng = random.Random(seed)
    queries: List[str] = list(traffic["queries"])
    done: List[Tuple[str, object, object, Optional[dict]]] = []
    errors: List[str] = []
    ends: List[float] = []
    if tracer is not None:
        tracer.begin()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        order = queries[:]
        rng.shuffle(order)
        label = (tracer.label if tracer is not None
                 else lambda name: contextlib.nullcontext())
        with label("loop"):
            for name in order:
                start = clock.mark()
                try:
                    with label(f"query:{name}"):
                        out = plans[name].run()
                    with label(f"copy:{name}"):
                        host = _to_host(out)
                except Exception as e:   # a failed query counts as failed
                    host = None
                    errors.append(f"{name}: {type(e).__name__}: {e}")
                done.append((name, start, clock.mark(), host))
                ends.append(time.perf_counter() - t0)
        if tracer is not None and tracer.due():
            tracer.end(len(done))
    window_s = time.perf_counter() - t0
    if tracer is not None and tracer.active:
        tracer.end(len(done))
    return {"done": done, "window_s": window_s, "errors": errors,
            "ends_s": ends}
