"""The port's train step on all ten archs' smoke configs, in the port
alone (``tests/test_models_smoke.py``'s train-step case mirrored): the
loss is finite, every gradient is finite, their norm is positive
(gradients flow through every block type), and one SGD step lowers the
loss.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import arch_ids, get_smoke_config
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import LM
from repro_torch.prng import PRNGKey
from repro_torch.tree import flatten_with_paths, tree_map

@pytest.mark.parametrize("arch", arch_ids())
def test_train_step_reduces_loss_and_finite(arch):
    cfg = get_smoke_config(arch)
    model = LM(cfg)
    rng = np.random.default_rng(1)
    params = model.init(PRNGKey(1), device="cpu")
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)).astype(
        np.int32))
    kwargs = {}
    if cfg.family == "encdec":
        kwargs["frames"] = torch.from_numpy(rng.normal(
            size=(2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        kwargs["patch_embeds"] = torch.from_numpy(rng.normal(
            size=(2, cfg.n_patches, cfg.d_model)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)).astype(
        np.int64))

    def loss_fn(p, batch):
        logits, aux = model.forward(p, tokens, **kwargs)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None]).mean()
        return nll + 0.01 * aux, nll

    loss, _, grads = loss_and_grads(loss_fn, params, None)
    assert np.isfinite(float(loss))
    flat = flatten_with_paths(grads)[1]
    assert all(bool(torch.isfinite(g).all()) for g in flat)
    gnorm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                           for g in flat))
    assert float(gnorm) > 0
    lr = 0.05
    params2 = tree_map(lambda p, g: p - lr * g.to(p.dtype), params, grads)
    with torch.no_grad():
        loss2, _ = loss_fn(params2, None)
    assert float(loss2) < float(loss)

