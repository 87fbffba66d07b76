#!/usr/bin/env python3
"""Time the port's ``onehot_matmul`` kernel on one NVIDIA card, at the
reference's two bench shapes in fp32 and bf16, the second with non-finite
entries in the first, a middle and the last row slab (the NaN rule's path),
and the SF 10 ``lineorder`` supplier positions into ``supplier``, for the
``repro_torch`` package under ``--src``; with ``--ab DIR``, also against the
kernel of the package under ``DIR`` in one process, in the order A, B, B, A.

    python3 scripts/torch_onehot_times.py [--src DIR] [--label NAME]
        [--ab DIR --ab-label NAME]

Each shape prints one JSON line: ``equal`` (kernel equal to plain, NaN in
the same places; ``ab_equal`` for A), the path the launch took,
``kernel_ms`` (CUDA events around one call, median of 10 after 2 warm-ups,
as ``chip_smoke.py`` times it), ``device_ms`` (events around 100
back-to-back calls, over 100, the stream held while the host enqueues
them), ``host_us`` (host clock per call over 100 calls with no synchronize),
``plain_ms`` (one call), ``library_ms`` (``index_select``, which skips the
NaN rule), ``bound_ms``; with ``--ab``, ``a_ms``/``b_ms``,
``a_device_ms``/``b_device_ms`` and ``a_host_us``/``b_host_us``, each pair
measured in the order A, B, B, A.
"""
from __future__ import annotations

import json

from torch_tree_predict_times import setup


def ab(measure, a_fn, b_fn):
    """([A, A], [B, B]) of ``measure``, taken A, B, B, A."""
    a1, b1, b2, a2 = (measure(f) for f in (a_fn, b_fn, b_fn, a_fn))
    return [a1, a2], [b1, b2]


def shapes(dev):
    """(label, idx, table), made one at a time."""
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.data import generate_ssb
    from repro_torch.kernels.onehot_matmul.ops import launch_geometry

    rng = np.random.default_rng(0)
    for n, r, d in chip_smoke.ONEHOT_BENCH_SHAPES:
        idx = torch.from_numpy(rng.integers(0, r, n).astype(np.int32)).to(dev)
        tbl = rng.normal(size=(r, d)).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            yield (f"bench n={n} r={r} d={d}", idx,
                   torch.from_numpy(tbl).to(dev, dtype))
    geom = launch_geometry(1, r, d, True)    # slabs depend on r, d only
    slabs = (0, geom.slabs // 2, geom.slabs - 1)
    for s, bad in zip(slabs, (np.nan, np.inf, -np.inf)):
        tbl[s * geom.slab_rows + 1, (7 * s) % d] = bad
    yield (f"bench n={n} r={r} d={d} non-finite in slabs {slabs} of "
           f"{geom.slabs}", idx, torch.from_numpy(tbl).to(dev))
    data = generate_ssb(sf=chip_smoke.SF, scale=1.0, seed=0, device=dev)
    pos, matrix = chip_smoke.onehot_sf_inputs(data)
    del data
    torch.cuda.empty_cache()
    yield f"SF {chip_smoke.SF} lineorder->supplier", pos, matrix


def main():
    args, other = setup()
    import torch

    import chip_smoke
    from repro_torch.kernels import onehot_matmul, onehot_matmul_ref

    dev = torch.device("cuda")
    for label, idx, tbl in shapes(dev):
        want, plain_ms = chip_smoke.timed_once(
            lambda: onehot_matmul_ref(idx, tbl))
        got = onehot_matmul(idx, tbl)
        row = dict(kernel="onehot_matmul", label=args.label, case=label,
                   n=int(idx.shape[0]), r=int(tbl.shape[0]),
                   d=int(tbl.shape[1]), dtype=str(tbl.dtype).split(".")[1],
                   path=chip_smoke.onehot_path(),
                   equal=chip_smoke.same(got, want))
        del got
        nbytes, ops = chip_smoke.onehot_bytes_ops(idx, tbl)
        row["bound_ms"], row["bound_by"], row["bound_rate"] = (
            chip_smoke.bound(nbytes, ops))
        call = lambda: onehot_matmul(idx, tbl)  # noqa: E731
        row.update(kernel_ms=chip_smoke.time_ms(call),
                   device_ms=chip_smoke.device_ms(call),
                   host_us=chip_smoke.host_us(call), plain_ms=plain_ms,
                   library_ms=chip_smoke.time_ms(
                       chip_smoke.onehot_library_call(idx, tbl)))
        if other is not None:
            a_call = lambda: other.onehot_matmul(idx, tbl)  # noqa: E731
            row["ab_label"] = args.ab_label
            row["ab_equal"] = chip_smoke.same(a_call(), want)
            for key, measure in (("ms", chip_smoke.time_ms),
                                 ("device_ms", chip_smoke.device_ms),
                                 ("host_us", chip_smoke.host_us)):
                row[f"a_{key}"], row[f"b_{key}"] = ab(measure, a_call, call)
        print(json.dumps(row), flush=True)
        del want, idx, tbl
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
