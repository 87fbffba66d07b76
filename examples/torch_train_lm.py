"""Train a reduced-config LM for a few hundred steps with the PyTorch/CUDA
port (the counterpart of ``examples/train_lm.py``).

Exercises the full training substrate: token pipeline → train step
(AdamW, clipping, z-loss) → async checkpoints → resume.  Checkpoints go
under the system's temporary directory.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--arch xlstm-125m]
          [--device cpu]
"""
import argparse
import os
import shutil
import tempfile

from repro_torch.launch.train import train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    ckpt = os.path.join(tempfile.gettempdir(), "repro_torch_example_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    # Every 50 steps, as the reference's example; a shorter run saves at
    # its end, so the restart below resumes there too.
    losses = train(args.arch, smoke=True, steps=args.steps, batch=8,
                   seq=128, ckpt_dir=ckpt, ckpt_every=min(50, args.steps),
                   device=args.device)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'improved' if losses[-1] < losses[0] else 'NO IMPROVEMENT'})")
    assert losses[-1] < losses[0], "the loss did not improve"
    # Resume from checkpoint for a handful more steps (restart path).
    more = train(args.arch, smoke=True, steps=args.steps + 10, batch=8,
                 seq=128, ckpt_dir=ckpt, ckpt_every=0, device=args.device)
    print(f"resumed and ran {len(more)} more steps; final {more[-1]:.3f}")
    assert len(more) == 10, "the restart did not resume from the checkpoint"
    shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    main()
