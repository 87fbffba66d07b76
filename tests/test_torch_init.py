"""``LM.init`` of the port against the reference's, from the same key:
``LM(cfg).init(PRNGKey(0))`` and ``repro``'s ``LM(cfg).init(
jax.random.PRNGKey(0))`` at the smoke configs (fp32), leaf by leaf.  This
file holds the first five archs and the key tree; ``test_torch_init_b.py``
the other five.

* The keys each leaf is drawn under are the reference's split tree (five
  top keys, per-repeat keys for the stacked leaves, each layer's own
  splits), bit for bit.
* Paths, shapes and dtypes equal the reference's; the leaves no key
  decides (norms, biases, Mamba's ``A_log`` and ``D``) are equal.
* A drawn leaf equals the reference's bit for bit: ``TN_ULP`` and
  ``TN_SHARE`` are 0, since the truncated normal is exact
  (``test_torch_prng.py``: XLA's CPU ``log1p`` and an exactly rounded
  fp32 multiply-add).
* So does its bf16 rounding, as a bf16 config stores it (``BF16_SHARE``
  is 0).  The checks keep their ulp and share form, so a regression
  reports how far and how often the leaves moved.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import arch_ids as ref_arch_ids
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import LM as RefLM
from repro_torch import prng
from repro_torch.configs import get_smoke_config
from repro_torch.models import LM
from repro_torch.models.common import Dense, Fixed
from repro_torch.prng import PRNGKey
from repro_torch.tree import flatten_with_paths

ARCHS = ref_arch_ids()
#: Largest ulp distance of a drawn fp32 element from the reference's.
TN_ULP = 0
#: Largest share of drawn elements that differ from the reference's.
TN_SHARE = 0
#: Largest share of elements whose bf16 rounding differs.
BF16_SHARE = 0


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    def line(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(
            np.int64)
        return np.where(i >= 0, i, -(i & 0x7FFFFFFF))
    return np.abs(line(a) - line(b))


def check_arch(arch):
    """The port's parameters against the reference's for ``arch``."""
    # Jitted, as the reference's driver runs it (the same values as the
    # op-by-op init, in a fraction of the time).
    want = jax.jit(RefLM(ref_get_smoke_config(arch)).init)(
        jax.random.PRNGKey(0))
    model = LM(get_smoke_config(arch))
    got = model.init(PRNGKey(0), device="cpu")
    kinds = flatten_with_paths(model.describe(PRNGKey(0)))[1]
    wp, wl = flatten_with_paths(want)
    gp, gl = flatten_with_paths(got)
    assert gp == wp
    n = differ = bf16_differ = 0
    for path, g, w, kind in zip(gp, gl, wl, kinds):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path
        g, w = g.numpy(), np.array(w)
        if isinstance(kind, Fixed):
            np.testing.assert_array_equal(g, w, err_msg=path)
            continue
        assert isinstance(kind, Dense) and g.dtype == np.float32, path
        d = _ulps(g, w)
        assert d.max(initial=0) <= TN_ULP, (path, int(d.max()))
        n += d.size
        differ += int((d > 0).sum())
        gb = torch.from_numpy(g).to(torch.bfloat16).float()
        wb = torch.from_numpy(w).to(torch.bfloat16).float()
        moved = gb != wb
        bf16_differ += int(moved.sum())
        # One bf16 ulp (8 bits of mantissa) apart where they differ.
        assert bool(((gb - wb).abs()[moved] <= wb.abs()[moved] / 64).all())
    assert n and differ <= TN_SHARE * n, (differ, n)
    assert bf16_differ <= BF16_SHARE * n, (bf16_differ, n)


@pytest.mark.parametrize("arch", ARCHS[:5])
def test_init_matches_reference(arch):
    check_arch(arch)


def _ref_key(path: str, cfg) -> np.ndarray:
    """The key the reference draws leaf ``path`` under (stacked leaves:
    every repeat's), rebuilt with ``jax.random.split`` along its init."""
    split = jax.random.split
    k_embed, k_head, k_layers, k_enc, k_cross = split(jax.random.PRNGKey(0),
                                                      5)
    parts = path.split("/")
    if parts[0] in ("embed", "lm_head"):
        return np.asarray({"embed": k_embed, "lm_head": k_head}[parts[0]])
    if parts[0] == "encoder":
        keys, mixer = list(split(k_enc, cfg.n_encoder_layers)), parts[1:]
    else:
        layer = int(parts[1].removeprefix("layer"))
        top = k_layers if parts[0] == "blocks" else k_cross
        keys = [split(k, len(cfg.pattern))[layer]
                for k in split(top, cfg.n_repeats)]
        if parts[0] == "cross":
            keys = [split(k, 4) for k in keys]
            i = ["wq", "wk", "wv", "wo"].index(parts[-1])
            return np.stack([np.asarray(k[i]) for k in keys])
        mixer = parts[2:]
    keys = [split(k, 3)[0 if mixer[0] in ("attn", "mamba", "mlstm",
                                          "slstm") else 1]
            for k in keys]
    order = {"attn": (4, ["wq", "wk", "wv", "wo"]),
             "mamba": (6, ["in_proj", "conv_w", "x_proj", "dt_proj",
                           "out_proj"]),
             "mlstm": (7, ["up", "wq", "wk", "wv", "wif", "down"]),
             "slstm": (3, ["w", "r", "down"]),
             "mlp": (2, ["wi", "wo"]),
             "moe": (4, ["router", "wi", "wo", "shared"])}
    n, names = order[mixer[0]]
    keys = [split(k, n)[names.index(mixer[1])] for k in keys]
    if mixer[0] == "moe" and mixer[1] == "shared":
        keys = [split(k, 2)[["wi", "wo"].index(mixer[2])] for k in keys]
    return np.stack([np.asarray(k) for k in keys])


@pytest.mark.parametrize("arch", ("whisper-tiny", "jamba-1.5-large-398b",
                                  "xlstm-125m", "qwen2-moe-a2.7b"))
def test_leaf_keys_are_the_reference_split_tree(arch):
    """Every drawn leaf's key (a stacked leaf's batch of keys) equals the
    key the reference's init draws it under."""
    cfg = get_smoke_config(arch)
    paths, leaves = flatten_with_paths(LM(cfg).describe(PRNGKey(0)))
    drawn = 0
    for path, leaf in zip(paths, leaves):
        if isinstance(leaf, Dense):
            np.testing.assert_array_equal(
                leaf.key.numpy(),
                _ref_key(path, cfg).astype(np.int64).reshape(leaf.key.shape),
                err_msg=path)
            drawn += 1
    assert drawn >= 6
    assert torch.equal(prng.split(PRNGKey(0), 5)[0],
                       LM(cfg).describe(PRNGKey(0))["embed"].key)
