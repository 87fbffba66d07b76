"""End-to-end serving driver of the PyTorch/CUDA port (the counterpart of
``examples/fused_serving.py``).

Batched requests → pre-fused star pipeline (paper Eq. 1) for per-request
features → LM decode conditioned on those features, with KV caches.
Reports latency percentiles fused vs non-fused and verifies the outputs
are identical (fusion is exact).

Run:  PYTHONPATH=src python examples/torch_fused_serving.py [--device cpu]
"""
import argparse

from repro_torch.launch.serve import run_serving

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    run_serving(arch="smollm-360m", batch=4, decode_steps=8, k=96, l=8,
                repeats=10, device=args.device)
