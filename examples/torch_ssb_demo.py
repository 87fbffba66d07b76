"""SSB demo of the PyTorch/CUDA port: run the Star Schema Benchmark queries
through the LAQ engine (the counterpart of ``examples/ssb_demo.py``).

Generates an SSB instance and executes all 13 queries (and the predictive
ones of the registry), printing result cardinalities and a few group-by
outputs.

Run:  PYTHONPATH=src python examples/torch_ssb_demo.py [--sf 2]
          [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.laq import PAD_GROUP, decode_composite
from repro_torch.data import QUERIES, generate_ssb
from repro_torch.device import resolve_device


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=1)
    ap.add_argument("--scale", type=float, default=0.003)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    data = generate_ssb(sf=args.sf, scale=args.scale, seed=0, device=dev)
    print(f"SSB sf={args.sf} (scaled ×{args.scale}): "
          f"lineorder={int(data.lineorder.nvalid)} rows")

    for name, q in QUERIES.items():
        q(data)  # warm-up, as the reference's first call compiles
        _sync(dev)
        t0 = time.perf_counter()
        res = q(data)
        _sync(dev)
        dt = (time.perf_counter() - t0) * 1e3
        key = next(k for k in ("revenue", "profit", "prediction")
                   if k in res)
        vals = res[key].cpu().numpy()
        if "groups" not in res:
            print(f"{name}: rows={int(res['rows']):7d} "
                  f"{key}_total={float(vals.sum()):.2f}  ({dt:.1f} ms)")
        else:
            groups = res["groups"].cpu().numpy()
            live = groups != PAD_GROUP
            print(f"{name}: rows={int(res['rows']):7d} "
                  f"groups={int(live.sum()):5d} "
                  f"{key}_total={vals.sum():.2f}  ({dt:.1f} ms)")
    # Show a decoded group-by result (Q2.1 = year × brand).
    res = QUERIES["Q2.1"](data)
    groups = res["groups"].cpu().numpy()
    rev = res["revenue"].cpu().numpy()
    live = groups != PAD_GROUP
    year, brand = decode_composite(torch.as_tensor(groups[live][:5]),
                                   [8, 1000])
    print("Q2.1 head: year", np.asarray(year) + 1992, "brand",
          np.asarray(brand), "revenue", rev[live][:5].round(1))


if __name__ == "__main__":
    main()
