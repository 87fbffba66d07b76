"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, sequential) (port of ``repro.models.xlstm``).
[arXiv:2405.04517]

* The mLSTM runs in *chunkwise-parallel* form — quadratic attention-like
  compute inside fixed chunks, a linear recurrence on (C, n) chunk states
  across chunks (a loop over chunks where the reference runs
  ``lax.scan``).  Decode is the O(1) recurrent update.
* Input gates use log-sigmoid (bounded) rather than the paper's raw
  exponential gate, as in the reference: the chunkwise form stays
  overflow-free without the max-stabilizer bookkeeping.  Positions past
  ``t`` inside a chunk get ``-inf`` before the ``exp``; the normalizer is
  ``max(|n·q|, 1)``.
* The sLSTM is sequential (recurrent state mixing): a loop over S where
  the reference runs ``lax.scan``; its gates are sigmoids.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate

from .. import prng
from .act_sharding import constrain, flatten, local, unflatten
from .common import const_init, dense_init
from .config import ModelConfig


def _mlstm_dims(cfg: ModelConfig):
    d_in = int(cfg.xlstm.proj_factor * cfg.d_model)
    dh = d_in // cfg.n_heads
    return d_in, dh


# ============================== mLSTM ======================================
def init_mlstm(key, cfg: ModelConfig):
    """The projections under the reference's seven keys (the last unused),
    described."""
    d = cfg.d_model
    d_in, _ = _mlstm_dims(cfg)
    ks = prng.split(key, 7)

    def draw(i, shape):
        return dense_init(ks[..., i, :], shape, cfg.pdtype)

    return {
        "up": draw(0, (d, 2 * d_in)),                         # main, gate
        "wq": draw(1, (d_in, d_in)),
        "wk": draw(2, (d_in, d_in)),
        "wv": draw(3, (d_in, d_in)),
        "wif": draw(4, (d_in, 2 * cfg.n_heads)),
        "down": draw(5, (d_in, d)),
    }


def _mlstm_gates(params, xm, cfg):
    return _log_gates((xm @ params["wif"]).to(torch.float32), cfg.n_heads)


def _log_gates(gates, h: int):
    li = F.logsigmoid(gates[..., :h])              # log input gate ≤ 0
    lf = F.logsigmoid(gates[..., h:])              # log forget gate ≤ 0
    return li, lf


def mlstm_forward(params, x: torch.Tensor, cfg: ModelConfig,
                  chunk: int = 256) -> torch.Tensor:
    """Chunkwise-parallel mLSTM. x: (B, S, D); S divisible by chunk."""
    s = x.shape[1]
    nh = cfg.n_heads
    _, dh = _mlstm_dims(cfg)
    xz = x @ params["up"]
    xm, z = torch.chunk(xz, 2, dim=-1)
    q = unflatten(xm @ params["wq"], -1, (nh, dh)).to(torch.float32)
    k = unflatten(xm @ params["wk"], -1, (nh, dh)).to(torch.float32) \
        * dh ** -0.5
    v = unflatten(xm @ params["wv"], -1, (nh, dh)).to(torch.float32)
    gates = (xm @ params["wif"]).to(torch.float32)           # (B,S,2H)
    # Batch rows over the data-parallel axes, the rest whole: the
    # chunkwise form (and the log gates, whose backward DTensor lacks) is
    # exact on each position's rows.
    q, k, v = (constrain(t, "dp", None, None, None) for t in (q, k, v))
    gates = constrain(gates, "dp", None, None)
    y = local(lambda q, k, v, g: _mlstm_chunkwise(
        q, k, v, *_log_gates(g, nh), min(chunk, s)),
        getattr(q, "placements", None), q, k, v, gates)
    y = flatten(y, 2, 3).to(x.dtype)
    out = y * F.silu(z)
    return out @ params["down"]


def _mlstm_chunkwise(q, k, v, li, lf, chunk: int) -> torch.Tensor:
    """The chunkwise-parallel mLSTM over q, k, v (B, S, H, dh) fp32 and
    the log gates (B, S, H): y (B, S, H, dh) fp32."""
    b, s, nh, dh = q.shape
    nc = s // chunk

    # Reshape into chunks: (B, nc, chunk, H, ·)
    cq = q.reshape(b, nc, chunk, nh, dh)
    ck = k.reshape(b, nc, chunk, nh, dh)
    cv = v.reshape(b, nc, chunk, nh, dh)
    cli = li.reshape(b, nc, chunk, nh)
    clf = lf.reshape(b, nc, chunk, nh)
    cum_f = torch.cumsum(clf, dim=2)                         # within-chunk
    total_f = cum_f[:, :, -1]                                # (B,nc,H)

    # Intra-chunk: y[t] = Σ_{u≤t} exp(cumf_t − cumf_u + li_u)(q_t·k_u) v_u
    decay = cum_f[:, :, :, None, :] - cum_f[:, :, None, :, :] \
        + cli[:, :, None, :, :]                              # (B,nc,t,u,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))
    decay = torch.where(tri[None, None, :, :, None], decay, -torch.inf)
    w_tu = torch.exp(decay)
    scores = torch.einsum("bcthd,bcuhd->bctuh", cq, ck) * w_tu
    y_intra = torch.einsum("bctuh,bcuhd->bcthd", scores, cv)

    # Inter-chunk state recurrence: C_c = exp(total_f) C_{c-1} + Σ_u exp(
    # total_f − cumf_u + li_u) k_u v_uᵀ  (and n likewise with k_u).
    w_u = torch.exp(total_f[:, :, None] - cum_f + cli)       # (B,nc,chunk,H)
    dC = torch.einsum("bcuh,bcuhd,bcuhe->bchde", w_u, ck, cv)
    dn = torch.einsum("bcuh,bcuhd->bchd", w_u, ck)

    c_state = torch.zeros((b, nh, dh, dh), dtype=torch.float32,
                          device=q.device)
    n_state = torch.zeros((b, nh, dh), dtype=torch.float32, device=q.device)
    c_prev, n_prev = [], []
    for c in range(nc):                       # state entering each chunk
        c_prev.append(c_state)
        n_prev.append(n_state)
        decay_c = torch.exp(total_f[:, c])[:, :, None, None]   # (B,H,1,1)
        c_state = c_state * decay_c + dC[:, c]
        n_state = n_state * decay_c[..., 0] + dn[:, c]
    c_prev = torch.stack(c_prev, dim=1)                      # (B,nc,H,dh,dh)
    n_prev = torch.stack(n_prev, dim=1)

    # Inter-chunk contribution to each position.
    qw = cq * torch.exp(cum_f)[..., None]                    # (B,nc,t,H,dh)
    y_inter = torch.einsum("bcthd,bchde->bcthe", qw, c_prev)
    # Normalizer: inter-chunk n·q plus intra-chunk decayed key sums.
    n_inter = torch.einsum("bcthd,bchd->bcth", qw, n_prev)
    n_intra = torch.einsum("bctuh,bcuhd,bcthd->bcth", w_tu, ck, cq)
    denom = torch.clamp(torch.abs(n_inter + n_intra), min=1.0)
    y = (y_intra + y_inter) / denom[..., None]
    return y.reshape(b, s, nh, dh)


class MLSTMState(NamedTuple):
    c: torch.Tensor  # (B, H, dh, dh)
    n: torch.Tensor  # (B, H, dh)


def init_mlstm_state(batch: int, cfg: ModelConfig,
                     device=None) -> MLSTMState:
    _, dh = _mlstm_dims(cfg)
    return MLSTMState(
        torch.zeros((batch, cfg.n_heads, dh, dh), dtype=torch.float32,
                    device=device),
        torch.zeros((batch, cfg.n_heads, dh), dtype=torch.float32,
                    device=device))


def mlstm_decode_step(params, x, state: MLSTMState, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, MLSTMState]:
    """O(1) recurrent step. x: (B, 1, D); the new state is fresh tensors."""
    b = x.shape[0]
    nh = cfg.n_heads
    d_in, dh = _mlstm_dims(cfg)
    xz = x @ params["up"]
    xm, z = torch.chunk(xz, 2, dim=-1)
    q = unflatten(xm @ params["wq"], -1, (nh, dh))[:, 0].to(torch.float32)
    k = unflatten(xm @ params["wk"], -1, (nh, dh))[:, 0].to(
        torch.float32) * dh ** -0.5
    v = unflatten(xm @ params["wv"], -1, (nh, dh))[:, 0].to(torch.float32)
    li, lf = _mlstm_gates(params, xm, cfg)                   # (B,1,H)
    fi = torch.exp(lf[:, 0])[..., None, None]                # (B,H,1,1)
    ii = torch.exp(li[:, 0])[..., None, None]
    c_new = state.c * fi + ii * k[..., :, None] * v[..., None, :]
    n_new = state.n * fi[..., 0] + ii[..., 0] * k
    num = torch.einsum("bhde,bhd->bhe", c_new, q)
    den = torch.clamp(torch.abs(torch.einsum("bhd,bhd->bh", n_new, q)),
                      min=1.0)
    y = (num / den[..., None]).reshape(b, 1, d_in).to(x.dtype)
    out = y * F.silu(z)
    return out @ params["down"], MLSTMState(c_new, n_new)


# ============================== sLSTM ======================================
def init_slstm(key, cfg: ModelConfig):
    """The projections under the reference's three keys, described."""
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    ks = prng.split(key, 3)
    return {
        # Input and recurrent (block-diagonal per head) gate projections.
        "w": dense_init(ks[..., 0, :], (d, 4 * d), cfg.pdtype),
        "r": dense_init(ks[..., 1, :], (nh, dh, 4 * dh), cfg.pdtype),
        "b": const_init(key, (4 * d,), cfg.pdtype, 0.0),
        "down": dense_init(ks[..., 2, :], (d, d), cfg.pdtype),
    }


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, D)
    n: torch.Tensor  # (B, D)
    h: torch.Tensor  # (B, D)


def init_slstm_state(batch: int, cfg: ModelConfig,
                     device=None) -> SLSTMState:
    """Three separate zero tensors (a decode writes each in place)."""
    d = cfg.d_model
    return SLSTMState(*(torch.zeros((batch, d), dtype=torch.float32,
                                    device=device) for _ in range(3)))


def _slstm_step(params, cfg, state: SLSTMState, xt: torch.Tensor):
    """xt: (B, 4D) pre-projected input gates; recurrent mixing per head."""
    b, d = state.h.shape
    nh = cfg.n_heads
    dh = d // nh
    hprev = state.h.reshape(b, nh, dh)
    rec = torch.einsum("bhd,hde->bhe", hprev.to(torch.float32),
                       params["r"].to(torch.float32)).reshape(b, 4 * d)
    g = xt.to(torch.float32) + rec + params["b"].to(torch.float32)
    i_, f_, z_, o_ = torch.chunk(g, 4, dim=-1)
    i = torch.sigmoid(i_)   # bounded input gate (see module docstring)
    f = torch.sigmoid(f_)
    z = torch.tanh(z_)
    o = torch.sigmoid(o_)
    c = f * state.c + i * z
    n = f * state.n + i
    h = o * c / torch.clamp(n, min=1.0)
    return SLSTMState(c, n, h)


def slstm_forward(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Sequential loop over S. x: (B, S, D).  On DTensors the loop runs on
    each position's batch rows, with the gates and the recurrent weights
    whole."""
    xg = constrain(x @ params["w"], "dp", None, None)        # (B,S,4D)
    rows = getattr(xg, "placements", None)
    r, bias = params["r"], params["b"]
    if rows is not None:
        r, bias = (t.redistribute(t.device_mesh,
                                  [Replicate()] * t.device_mesh.ndim)
                   for t in (r, bias))

    def loop(xg, r, bias):
        state = init_slstm_state(xg.shape[0], cfg, device=xg.device)
        hs = []
        for t in range(xg.shape[1]):
            state = _slstm_step({"r": r, "b": bias}, cfg, state, xg[:, t])
            hs.append(state.h)
        return torch.stack(hs, dim=1)

    y = local(loop, rows, xg, r, bias).to(x.dtype)           # (B,S,D)
    return y @ params["down"]


def slstm_decode_step(params, x, state: SLSTMState, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, SLSTMState]:
    xg = (x @ params["w"])[:, 0]
    new = _slstm_step(params, cfg, state, xg)
    y = new.h[:, None, :].to(x.dtype)
    return y @ params["down"], new
