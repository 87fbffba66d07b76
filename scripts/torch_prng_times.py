#!/usr/bin/env python3
"""Time the port's parameter draw on one NVIDIA card: a truncated normal of
``--elements`` elements under ``PRNGKey(0)`` on the models' bounds ±2
(``prng.truncated_normal``, what ``LM.init`` draws), for the ``repro_torch``
package under ``--src``; with ``--ab DIR``, also the draw of the package
under ``DIR`` in one process, in the order A, B, B, A.

    python3 scripts/torch_prng_times.py [--src DIR] [--ab DIR]
        [--elements N]

The draw is hundreds of short element-wise passes, not one kernel, so each
timing is the host clock between two synchronizes (the median of 3 draws);
each package's peak device memory over a draw (``max_memory_allocated``
above what was allocated before) is printed beside it.  Then the card's
draw of a 2**22-element box is held against the CPU's, bit for bit.  One
JSON line.  To compare with another commit, unpack it with ``git archive``
under ``build/`` and pass its ``src`` as ``--ab``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS = 3
CHECK_ELEMENTS = 1 << 22


def load_prng(src: str, name: str):
    """``repro_torch/prng.py`` under ``src`` as the module ``name`` (it
    imports only numpy and torch)."""
    spec = importlib.util.spec_from_file_location(
        name, Path(src).resolve() / "repro_torch" / "prng.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def draw_seconds(prng, n: int, dev) -> float:
    import torch
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        prng.truncated_normal(prng.PRNGKey(0), -2.0, 2.0, (n,), device=dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return statistics.median(times)


def draw_peak(prng, n: int, dev) -> int:
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    prng.truncated_normal(prng.PRNGKey(0), -2.0, 2.0, (n,), device=dev)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package (B)")
    ap.add_argument("--ab", default=None,
                    help="directory holding another repro_torch package (A)")
    ap.add_argument("--elements", type=int, default=1 << 26)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT)]
    import torch

    import chip_smoke
    card = chip_smoke.phase_device()
    dev = torch.device("cuda")
    b = load_prng(args.src, "prng_b")
    a = load_prng(args.ab, "prng_a") if args.ab else None
    n = args.elements
    draw_seconds(b, 1 << 20, dev)
    row = dict(script="torch_prng_times", elements=n, src=args.src,
               ab=args.ab, slab=b.SLAB, card=card)
    if a is None:
        row.update(b_seconds=[draw_seconds(b, n, dev)])
    else:
        draw_seconds(a, 1 << 20, dev)
        a1 = draw_seconds(a, n, dev)
        b1 = draw_seconds(b, n, dev)
        b2 = draw_seconds(b, n, dev)
        a2 = draw_seconds(a, n, dev)
        row.update(a_seconds=[a1, a2], b_seconds=[b1, b2],
                   a_slab=a.SLAB, a_peak_bytes=draw_peak(a, n, dev),
                   b_over_a=statistics.mean([b1, b2])
                   / statistics.mean([a1, a2]))
    row.update(b_peak_bytes=draw_peak(b, n, dev))
    key = b.PRNGKey(7)
    card_draw = b.truncated_normal(key, -2.0, 2.0, (CHECK_ELEMENTS,),
                                   device=dev).cpu()
    cpu_draw = b.truncated_normal(key, -2.0, 2.0, (CHECK_ELEMENTS,),
                                  device="cpu")
    row.update(card_equals_cpu=bool(torch.equal(
        card_draw.view(torch.int32), cpu_draw.view(torch.int32))),
        check_elements=CHECK_ELEMENTS)
    print(json.dumps(row), flush=True)
    if not row["card_equals_cpu"]:
        raise SystemExit("the card's draw differs from the CPU's")


if __name__ == "__main__":
    main()
