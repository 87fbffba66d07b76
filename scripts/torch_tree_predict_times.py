#!/usr/bin/env python3
"""Time the port's ``tree_predict`` kernel against its plain version on one
NVIDIA card, at the SF 10 main path's tree shape and the paper's two widest
trees, for the ``repro_torch`` package found under ``--src``.

    python3 scripts/torch_tree_predict_times.py [--src DIR] [--label NAME]

Each shape prints one JSON line (``chip_smoke.check_tree``'s row: kernel
equal to plain, ``kernel_ms``/``plain_ms`` as the median of CUDA-event
timings, ``bound_ms``).  To compare two versions of the kernel, run it on
each version's ``src`` in one session on the card, in the order A, B, B, A.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (rows, features, depth): SF 10 P3 (p=7, l=8), then setting 1 and 2 trees.
SHAPES = ((60_000_000, 5, 3), (4_800_000, 128, 7), (6_000, 512, 9))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    ap.add_argument("--label", default="", help="tag printed in each row")
    args = ap.parse_args()
    sys.path[:0] = [args.src, str(ROOT)]
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.core.fusion import random_tree

    chip_smoke.phase_device()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for n, k, depth in SHAPES:
        tree = random_tree(rng, k, depth).to(dev)
        x = torch.randn(n, k, device=dev, generator=gen)
        chip_smoke.check_tree(f"{args.label} n={n} k={k} depth={depth}", x,
                              tree, timing=True)
        del x
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
