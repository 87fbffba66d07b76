#!/usr/bin/env python3
"""Time the port's ``fused_star_gather`` kernel against its plain version on
one NVIDIA card, at the SF 10 main path's P1 shape (the fused plan's own
pointers and partials) and the paper's two settings (linear heads and tree
partials with ``== h``), for the ``repro_torch`` package under ``--src``;
with ``--ab DIR``, also against the kernel of the package under ``DIR`` in
one process, in the order A, B, B, A.

    python3 scripts/torch_gather_times.py [--src DIR] [--label NAME]
        [--ab DIR --ab-label NAME]

Each shape prints one JSON line, as ``scripts/torch_tree_predict_times.py``
does: kernel equal to plain (and to A), ``kernel_ms``/``plain_ms`` (median
of 10 CUDA-event timings after 2 warm-ups), ``bound_ms``, and with ``--ab``
``a_ms``/``b_ms`` in the order A, B, B, A, and ``a_device_ms``/
``b_device_ms``, the device time alone (``chip_smoke.device_ms``: calls
back to back behind a held stream), also A, B, B, A.
"""
from __future__ import annotations

import json

from torch_tree_predict_times import ab_times, setup


def shapes(dev):
    """(label, ptrs, founds, partials, h) at the main path's and the
    paper's shapes, made one at a time."""
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.core.fusion import LinearOperator, prefuse, random_tree
    from repro_torch.core.laq import stack_joins
    from repro_torch.core.query import compile_query
    from repro_torch.data import QUERY_IR, generate_ssb, generate_star

    data = generate_ssb(sf=chip_smoke.SF, scale=1.0, seed=0, device=dev)
    plan = compile_query(data.tables(), QUERY_IR["P1.linear.year"](),
                         backend="fused", serve_backend="kernel")
    st = plan._state
    yield (f"SF {chip_smoke.SF} P1.linear.year", *st["stacked_joins"],
           list(st["partials"]), st["h"])
    del plan, st, data
    torch.cuda.empty_cache()
    for setting, sf, k, l, depth in ((1, 8, 128, 128, 7),
                                     (2, 2, 512, 2048, 9)):
        star = generate_star(setting, sf, k, seed=setting, scale=1.0,
                             device=dev).star
        ptrs, founds = stack_joins(star.joins)
        rng = np.random.default_rng(setting)
        lin = LinearOperator(torch.from_numpy(
            (rng.normal(size=(k, l)) / np.sqrt(k)).astype(np.float32))).to(dev)
        yield (f"setting {setting} linear l={l}", ptrs, founds,
               list(prefuse(star, lin).partials), None)
        tpre = prefuse(star, random_tree(rng, k, depth).to(dev))
        yield (f"setting {setting} tree depth={depth} l={tpre.h.shape[0]}",
               ptrs, founds, list(tpre.partials), tpre.h)
        del star, ptrs, founds, tpre
        torch.cuda.empty_cache()


def main():
    args, other = setup()
    import torch

    import chip_smoke
    from repro_torch.kernels import fused_star_gather, fused_star_gather_ref

    dev = torch.device("cuda")
    for label, ptrs, founds, parts, h in shapes(dev):
        gargs = (ptrs, founds, parts, h)
        want = fused_star_gather_ref(*gargs)
        row = dict(kernel="fused_star_gather", label=args.label, case=label,
                   J=int(ptrs.shape[0]), n=int(ptrs.shape[1]),
                   l=int(parts[0].shape[1]),
                   equal=chip_smoke.same(fused_star_gather(*gargs), want))
        nbytes, ops = chip_smoke.gather_bytes_ops(ptrs, parts, h)
        row["bound_ms"], row["bound_by"], row["bound_rate"] = (
            chip_smoke.bound(nbytes, ops))
        row["kernel_ms"] = chip_smoke.time_ms(
            lambda: fused_star_gather(*gargs))
        row["plain_ms"] = chip_smoke.time_ms(
            lambda: fused_star_gather_ref(*gargs))
        if other is not None:
            row["ab_label"] = args.ab_label
            row["ab_equal"] = chip_smoke.same(
                other.fused_star_gather(*gargs), want)
            row["a_ms"], row["b_ms"] = ab_times(
                lambda: other.fused_star_gather(*gargs),
                lambda: fused_star_gather(*gargs))
            # Device time alone (calls back to back behind a held stream),
            # A, B, B, A: the wrappers' host work drops out.
            row["a_device_ms"], row["b_device_ms"] = ab_times(
                lambda: other.fused_star_gather(*gargs),
                lambda: fused_star_gather(*gargs),
                timer=chip_smoke.device_ms)
        print(json.dumps(row), flush=True)
        del want, gargs
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
