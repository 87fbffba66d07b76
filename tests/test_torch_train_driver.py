"""The port's training driver (``repro_torch.launch.train.train``) on the
CPU at a smoke config: the loss falls, checkpoints are written every
``ckpt_every`` steps with the pipeline's state, and a run resumed from a
checkpoint continues with the uninterrupted run's losses **bit for bit**
(parameters, AdamW state and the token pipeline are restored exactly, and
the CPU's kernels are deterministic).
"""
import numpy as np
import pytest

from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch.train import train

ARGS = dict(arch="smollm-360m", smoke=True, batch=4, seq=32, lr=3e-3,
            log_every=100, device="cpu")


def test_train_resumes_with_the_same_losses(tmp_path):
    full = train(steps=6, ckpt_dir=str(tmp_path / "a"), ckpt_every=3,
                 **ARGS)
    assert len(full) == 6 and all(np.isfinite(full))
    assert np.mean(full[-2:]) < full[0]
    mgr = CheckpointManager(str(tmp_path / "a"))
    assert mgr.all_steps() == [3, 6]
    _, extras = mgr.restore(6, {})
    assert extras["pipeline"] == {"step": 6, "seed": 0}

    first = train(steps=3, ckpt_dir=str(tmp_path / "b"), ckpt_every=3,
                  **ARGS)
    assert first == full[:3]
    rest = train(steps=6, ckpt_dir=str(tmp_path / "b"), ckpt_every=3,
                 **ARGS)
    assert rest == full[3:]
    assert train(steps=6, ckpt_dir=str(tmp_path / "b"), ckpt_every=3,
                 **ARGS) == []


def test_train_without_a_card_raises(tmp_path, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = dict(ARGS)
    args.pop("device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(steps=1, ckpt_dir=str(tmp_path), ckpt_every=0, **args)
    assert not (tmp_path / "step_00000001").exists()
