"""Port parity: the LM token pipeline (``repro_torch.data.tokens``) against
the reference's ``repro.data.tokens``, and the reference's substrate
tests of it mirrored in the port.

Every comparison is exact: both packages draw the corpus with numpy from
``np.random.default_rng((seed, step, row))``, so tokens and labels are
equal bit for bit — from a fresh pipeline, through the prefetch thread,
after a restore mid-stream and on each of two host slices.
"""
import numpy as np
import pytest
import torch

from repro.data import TokenPipeline as RefPipeline
from repro.data import TokenPipelineConfig as RefConfig
from repro.data.tokens import ZipfCorpus as RefCorpus
from repro_torch.data import (TokenPipeline, TokenPipelineConfig,
                              make_global_batch)
from repro_torch.data.tokens import ZipfCorpus
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.launch.sharding import batch_pspec


def _pair(vocab=1000, batch=4, seq=32, seed=0, **kw):
    return (TokenPipeline(TokenPipelineConfig(vocab, batch, seq, seed), **kw),
            RefPipeline(RefConfig(vocab, batch, seq, seed), **kw))


def _stop(*pipes):
    for p in pipes:
        p.stop()


@pytest.mark.parametrize("vocab,seed", [(100, 0), (49152, 3), (151936, 7)])
def test_corpus_matches_reference(vocab, seed):
    got = ZipfCorpus(vocab, seed).batch(5, 3, 64, row_offset=11)
    want = RefCorpus(vocab, seed).batch(5, 3, 64, row_offset=11)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < vocab


def test_pipeline_matches_reference_with_restore_mid_stream():
    port, ref = _pair(process_index=0, process_count=1)
    for _ in range(3):
        (t, l), (rt, rl) = port.next(), ref.next()
        np.testing.assert_array_equal(t, rt)
        np.testing.assert_array_equal(l, rl)
    state = port.state()
    assert state == ref.state() == {"step": 3, "seed": 0}
    after = [port.next() for _ in range(2)]
    port2, ref2 = _pair(process_index=0, process_count=1)
    port2.restore(state)
    ref2.restore(ref.state())
    for want in after:
        (t, l), (rt, rl) = port2.next(), ref2.next()
        np.testing.assert_array_equal(t, want[0])
        np.testing.assert_array_equal(t, rt)
        np.testing.assert_array_equal(l, rl)


def test_two_host_slices_match_reference():
    rows = []
    for pi in range(2):
        port, ref = _pair(batch=6, process_index=pi, process_count=2)
        (t, l), (rt, rl) = port.next(), ref.next()
        assert t.shape == (3, 32)
        np.testing.assert_array_equal(t, rt)
        np.testing.assert_array_equal(l, rl)
        rows.append(t)
    whole, _ = _pair(batch=6, process_index=0, process_count=1)
    np.testing.assert_array_equal(np.concatenate(rows), whole.next()[0])


def test_prefetch_thread_matches_reference():
    port, ref = _pair(seq=16, process_index=0, process_count=1)
    port.start()
    ref.start()
    try:
        for _ in range(5):
            (t, l), (rt, rl) = port.next(), ref.next()
            np.testing.assert_array_equal(t, rt)
            np.testing.assert_array_equal(l, rl)
        port.restore({"step": 1, "seed": 0})     # stops the thread
        assert port._thread is None
        port.start()
        t, _ = port.next()
        np.testing.assert_array_equal(t, RefCorpus(1000, 0).batch(
            1, 4, 16, 0)[:, :-1])
    finally:
        _stop(port, ref)
    assert port._thread is None


def test_process_defaults_without_torch_distributed():
    port, _ = _pair()
    assert (port.pi, port.pc) == (0, 1)
    with pytest.raises(ValueError, match="does not split"):
        TokenPipeline(TokenPipelineConfig(10, 5, 4), process_index=0,
                      process_count=2)


def test_make_global_batch_on_one_process():
    mesh = make_serving_mesh((2, 1), device="cpu")
    local = np.arange(12, dtype=np.int32).reshape(3, 4)
    got = make_global_batch(local, mesh, batch_pspec(mesh))
    assert got.device.type == "cpu" and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), local)


# ------------------------------- tests/test_substrates.py, in the port ----
def test_token_pipeline_deterministic_and_restorable():
    cfg = TokenPipelineConfig(vocab_size=100, global_batch=4, seq_len=16)
    p1 = TokenPipeline(cfg, process_index=0, process_count=1)
    a_tok, a_lab = p1.next()
    b_tok, _ = p1.next()
    assert a_tok.shape == (4, 16) and a_lab.shape == (4, 16)
    np.testing.assert_array_equal(a_tok[:, 1:], a_lab[:, :-1])
    assert not np.array_equal(a_tok, b_tok)
    p2 = TokenPipeline(cfg, process_index=0, process_count=1)
    p2.restore({"step": 1, "seed": 0})
    np.testing.assert_array_equal(p2.next()[0], b_tok)


def test_token_pipeline_host_slices_disjoint_and_prefetch():
    cfg = TokenPipelineConfig(vocab_size=100, global_batch=4, seq_len=8)
    h0 = TokenPipeline(cfg, process_index=0, process_count=2)
    h1 = TokenPipeline(cfg, process_index=1, process_count=2)
    t0, _ = h0.next()
    t1, _ = h1.next()
    assert t0.shape == (2, 8) and not np.array_equal(t0, t1)
    h0.start()
    try:
        t0b, _ = h0.next()
    finally:
        h0.stop()
    assert t0b.shape == (2, 8)
