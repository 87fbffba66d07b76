"""Rematerialization in the port (``cfg.remat``: each repeat's super-block,
each encoder layer and each Mamba chunk under ``torch.utils.checkpoint``).

With ``remat=True`` the recompute runs the same operations on the same
inputs, so on the CPU the loss and every gradient equal the
``remat=False`` ones **bit for bit**, for an attention arch (whisper-tiny,
with its encoder and cross-attention), a MoE arch (qwen2-moe-a2.7b), a
Mamba arch (jamba-1.5-large-398b, with a Mamba chunk smaller than S so
the chunk checkpoints nest inside the block's) and an xLSTM arch
(xlstm-125m), each at its smoke config.  The bytes autograd saves
(``saved_tensors_hooks``, each storage once, parameters excluded) must
drop, and under ``torch.no_grad()`` (decode, serving) nothing is
rematerialized: the forward's logits are equal either way.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch.steps import loss_and_grads, make_loss_fn
from repro_torch.models import LM, mamba
from repro_torch.prng import PRNGKey
from repro_torch.tree import flatten_with_paths, unflatten

#: The archs of this file; ``test_torch_remat_b.py`` runs the Mamba and
#: xLSTM ones (jamba-1.5-large-398b, xlstm-125m) through ``check_remat``.
ARCHS = ("whisper-tiny", "qwen2-moe-a2.7b")


def _batch(cfg, rng, b=2, s=16):
    out = {"tokens": torch.from_numpy(rng.integers(
               0, cfg.vocab_size, (b, s)).astype(np.int32)),
           "labels": torch.from_numpy(rng.integers(
               0, cfg.vocab_size, (b, s)).astype(np.int32))}
    if cfg.family == "encdec":
        out["frames"] = torch.from_numpy(rng.normal(
            size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    return out


def _saved_bytes(cfg, params, batch):
    """Bytes autograd holds for the loss's backward (each storage once;
    the parameters and the batch excluded)."""
    leaves = flatten_with_paths(params)[1]
    skip = {t.untyped_storage().data_ptr()
            for t in leaves + list(batch.values())}
    req = unflatten(params, [t.detach().requires_grad_(True)
                             for t in leaves])
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in skip:
            seen[st.data_ptr()] = st.nbytes()
        return t

    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
            pack, lambda t: t):
        make_loss_fn(LM(cfg), cfg)(req, batch)
    return sum(seen.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_grads_equal_bit_for_bit_and_save_less(arch, monkeypatch):
    check_remat(arch, monkeypatch)


@pytest.mark.parametrize("arch", ARCHS)
def test_no_grad_forward_is_unchanged_by_remat(arch):
    check_no_grad_forward(arch)


def check_remat(arch, monkeypatch):
    base = dataclasses.replace(get_smoke_config(arch), remat=False)
    if base.mamba is not None:     # chunks of 4 of the 16 positions
        monkeypatch.setattr(mamba, "mamba_forward", functools.partial(
            mamba.mamba_forward, chunk=4))
    params = LM(base).init(PRNGKey(0), device="cpu")
    batch = _batch(base, np.random.default_rng(1))
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        tot, nll, grads = loss_and_grads(make_loss_fn(LM(cfg), cfg),
                                         params, batch)
        out[remat] = (tot, nll, flatten_with_paths(grads)[1])
    (t0, n0, g0), (t1, n1, g1) = out[False], out[True]
    assert torch.equal(t0, t1) and torch.equal(n0, n1)
    assert len(g0) == len(g1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    assert float(sum(g.float().square().sum() for g in g1)) > 0
    plain = _saved_bytes(base, params, batch)
    remat = _saved_bytes(dataclasses.replace(base, remat=True), params,
                         batch)
    assert remat < plain / 2, (remat, plain)


def check_no_grad_forward(arch):
    base = get_smoke_config(arch)
    params = LM(base).init(PRNGKey(2), device="cpu")
    batch = _batch(base, np.random.default_rng(3))
    kw = {"frames": batch["frames"]} if "frames" in batch else {}
    with torch.no_grad():
        want, aux = LM(dataclasses.replace(base, remat=False)).forward(
            params, batch["tokens"], **kw)
        got, aux2 = LM(dataclasses.replace(base, remat=True)).forward(
            params, batch["tokens"], **kw)
    assert torch.equal(want, got) and torch.equal(aux, aux2)
