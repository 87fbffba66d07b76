"""Run one cell of the benchmark on the card and print its result.

    python laqbench/run.py --workload ssb10.predictive --seed 7 \
        --seconds 20 --trace 0

Earlier lines of standard output describe the run (kernels, data, each
plan's choices, the window); the last line is the result: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its
limit, which also end standard error.  Exits non-zero with no result when
there is no card, when the program is missing, or when a JAX module is
loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CHIPS = 1


def _caches() -> None:
    """Kernel caches live at fixed paths inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    marks = {"python_s": time.perf_counter() - T0}
    import torch
    marks["import_torch_s"] = time.perf_counter() - T0
    if not torch.cuda.is_available() or torch.cuda.device_count() < CHIPS:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {CHIPS} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    marks["cuda_check_s"] = time.perf_counter() - T0
    torch.set_num_threads(2)
    from laqbench import harness
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T0, marks=marks)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded forbidden modules: {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
