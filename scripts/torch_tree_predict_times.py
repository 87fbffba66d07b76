#!/usr/bin/env python3
"""Time the port's ``tree_predict`` kernel against its plain version on one
NVIDIA card, at the SF 10 main path's tree shape and the paper's trees
(p = 7, 127, 511, up to the depth-13 tree, p = 8191), for the ``repro_torch``
package found under ``--src``; with ``--ab DIR``, also against the kernel of
the package under ``DIR`` in one process, in the order A, B, B, A.  Depths
10-13 at setting 2's width, at 6000 rows and at a 512-row serving batch,
give the planner's ``TREE_KERNEL_MAX_NODES``.

    python3 scripts/torch_tree_predict_times.py [--src DIR] [--label NAME]
        [--ab DIR --ab-label NAME]

Each shape prints one JSON line: kernel equal to plain (and to A), the
kernel's score path, ``kernel_ms``/``plain_ms`` as the median of 10
CUDA-event timings after 2 warm-ups, ``bound_ms`` (``chip_smoke.bound``);
with ``--ab``, ``a_ms`` and ``b_ms`` as the two timings of each in the order
A, B, B, A.  To compare with another commit, unpack it with ``git archive``
under ``build/`` and pass its ``src`` as ``--ab``.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (rows, features, depth): SF 10 P3 (p=7, l=8), setting 1 (p=127), setting 2
# (p=511), then deeper trees at setting 2's width up to the depth-13 edge
# tree (p=8191, l=8192), and three of them at serving's top bucket (512).
SHAPES = ((60_000_000, 5, 3), (4_800_000, 128, 7), (6_000, 512, 9),
          (6_000, 512, 10), (6_000, 512, 11), (6_000, 512, 12),
          (6_000, 512, 13), (512, 512, 9), (512, 512, 11), (512, 512, 13))


def load_kernels_as(src: str, name: str):
    """The ``kernels`` subpackage of the ``repro_torch`` package under
    ``src``, imported as the top-level package ``name`` (so two versions can
    live in one process; the package imports itself only relatively)."""
    init = Path(src).resolve() / "repro_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.kernels")


def ab_times(a_fn, b_fn, timer=None):
    """([A, A], [B, B]) timings, taken A, B, B, A: CUDA-event medians
    (``chip_smoke.time_ms``) unless ``timer`` says otherwise."""
    import chip_smoke
    timer = timer or chip_smoke.time_ms
    a1 = timer(a_fn)
    b1 = timer(b_fn)
    b2 = timer(b_fn)
    a2 = timer(a_fn)
    return [a1, a2], [b1, b2]


def setup(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package (B)")
    ap.add_argument("--label", default="", help="tag of --src's kernel")
    ap.add_argument("--ab", default=None,
                    help="directory holding another repro_torch package (A)")
    ap.add_argument("--ab-label", default="A", help="tag of --ab's kernel")
    args = ap.parse_args(argv)
    sys.path[:0] = [args.src, str(ROOT)]
    import chip_smoke
    chip_smoke.phase_device()
    other = load_kernels_as(args.ab, "repro_torch_ab") if args.ab else None
    return args, other


def main():
    args, other = setup()
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.core.fusion import random_tree
    from repro_torch import prng
    from repro_torch.kernels import tree_predict, tree_predict_ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    keys = prng.split(prng.PRNGKey(0), len(SHAPES))
    for (n, k, depth), key in zip(SHAPES, keys):
        tree = random_tree(rng, k, depth).to(dev)
        x = prng.truncated_normal(key, -2.0, 2.0, (n, k), device=dev)
        targs = (x, tree.F, tree.v, tree.H, tree.h)
        want = tree_predict_ref(*targs)
        got = tree_predict(*targs)
        path, dot_nodes = chip_smoke.tree_score_path()
        row = dict(kernel="tree_predict", label=args.label, n=n, k=k,
                   p=tree.p, l=tree.l, equal=chip_smoke.same(got, want),
                   score_path=path, dot_nodes=dot_nodes)
        del got
        nbytes, ops, score_ops = chip_smoke.tree_bytes_ops(x, tree.F, tree.H)
        row["bound_ms"], row["bound_by"], row["bound_rate"] = (
            chip_smoke.bound(nbytes, ops, score_ops))
        row["kernel_ms"] = chip_smoke.time_ms(lambda: tree_predict(*targs))
        row["plain_ms"] = chip_smoke.time_ms(lambda: tree_predict_ref(*targs))
        if other is not None:
            row["ab_label"] = args.ab_label
            row["ab_equal"] = chip_smoke.same(other.tree_predict(*targs),
                                              want)
            row["a_ms"], row["b_ms"] = ab_times(
                lambda: other.tree_predict(*targs),
                lambda: tree_predict(*targs))
        print(json.dumps(row), flush=True)
        del x, want, targs, tree
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
