"""Readings for the limits of ``correct``: the program's numbers over many
seeds and the bfloat16 control's, in one process on the card.

    python laqbench/control.py --workload ssb10.predictive \\
        --seeds 11,12,13 --control-seeds 11,12,13 --seconds 3

Each seed is a whole run of the cell with a short window (set-up, window,
reference check); a control seed also computes the reference in bfloat16
and judges it in the program's place.  One JSON line per seed.  The
benchmark's own runs never run the control.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from laqbench import harness
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run_cell(args.workload, seed, args.seconds, False,
                               "cuda", time.perf_counter(),
                               control=seed in ctl)
        row = {"reading": args.workload, "seed": seed,
               "correct": out["correct"], "attempted": out["attempted"],
               "program": {k: v["value"] for k, v in out["checks"].items()}}
        if "control" in out:
            row["control"] = {k: v["value"] for k, v in
                              out["control"]["checks"].items()}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
