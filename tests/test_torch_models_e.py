"""Port parity, fifth part: decode of the four archs with MoE, Mamba or
xLSTM layers (their KV caches and recurrent states) against the port's
own forward and the reference's decode chain, in the smoke configs (fp32,
on the CPU) — the port's mirror of ``tests/test_models_smoke.py:76-99``
for qwen2-moe, jamba and xlstm, with dbrx beside them — and the layout
and in-place advance of their decode states.

Tolerance: ``decode_step`` chains within ``DECODE_TOL`` (atol and rtol
1e-4) of the port's ``forward`` and of the reference's chain (the
reference's own test allows 2e-2); the largest difference seen was 6.6e-6
on logits of magnitude 4.  At S=8 no MoE pair is dropped in the forward
(capacity 8), so decode and forward route alike.
"""
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import LM, blocks
from repro_torch.models.attention import KVCache
from repro_torch.models.mamba import MambaState
from repro_torch.models.xlstm import MLSTMState, SLSTMState
from repro_torch.prng import PRNGKey
from test_torch_models import RECURRENT_MOE_ARCHS
from test_torch_models_b import check_decode


@pytest.mark.parametrize("arch", RECURRENT_MOE_ARCHS)
def test_decode_matches_forward_and_reference(arch):
    check_decode(arch)


STATE_TYPES = {"attn": KVCache, "mamba": MambaState, "mlstm": MLSTMState,
               "slstm": SLSTMState}


@pytest.mark.parametrize("arch", ("jamba-1.5-large-398b", "xlstm-125m"))
def test_recurrent_state_layout(arch):
    """One state per pattern position, by mixer, every tensor stacked over
    repeats; a step advances the states in place (the same tensors), and
    only a KV cache carries a length."""
    cfg = get_smoke_config(arch)
    lm = LM(cfg)
    params = lm.init(PRNGKey(0), device="cpu")
    state = lm.init_decode_state(params, 3, max_len=5)
    assert len(state.layer_states) == len(cfg.pattern)
    before = []
    for spec, st in zip(cfg.pattern, state.layer_states):
        assert type(st) is STATE_TYPES[spec.mixer]
        proto = blocks.init_block_state(cfg, spec, 3, 5, device="meta")
        tensors = [t for t in st if isinstance(t, torch.Tensor)]
        assert [tuple(t.shape) for t in tensors] == [
            (cfg.n_repeats,) + tuple(p.shape) for p in proto
            if isinstance(p, torch.Tensor)]
        assert all(float(t.abs().sum()) == 0 for t in tensors)
        before.append(tensors)
    ptrs = [t.data_ptr() for ts in before for t in ts]
    assert len(set(ptrs)) == len(ptrs)          # no two states alias
    _, state2 = lm.decode_step(params, state,
                               torch.tensor([1, 2, 3], dtype=torch.int32))
    assert state2.position == 1
    for spec, st, tensors in zip(cfg.pattern, state2.layer_states, before):
        now = [t for t in st if isinstance(t, torch.Tensor)]
        assert all(a is b for a, b in zip(now, tensors))
        if spec.mixer == "attn":
            assert st.length == 1
            assert float(st.k[:, :, 0].abs().sum()) > 0
            assert float(st.k[:, :, 1:].abs().sum()) == 0
        else:
            assert not hasattr(st, "length")
            # Every repeat's slice was written.
            for t in now:
                assert all(float(t[r].abs().sum()) > 0
                           for r in range(cfg.n_repeats))
