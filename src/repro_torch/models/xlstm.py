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

from .common import dense_init
from .config import ModelConfig


def _mlstm_dims(cfg: ModelConfig):
    d_in = int(cfg.xlstm.proj_factor * cfg.d_model)
    dh = d_in // cfg.n_heads
    return d_in, dh


# ============================== mLSTM ======================================
def init_mlstm(generator, cfg: ModelConfig, device=None):
    d = cfg.d_model
    d_in, _ = _mlstm_dims(cfg)

    def draw(shape):
        return dense_init(generator, shape, cfg.pdtype, device=device)

    return {
        "up": draw((d, 2 * d_in)),                            # main, gate
        "wq": draw((d_in, d_in)),
        "wk": draw((d_in, d_in)),
        "wv": draw((d_in, d_in)),
        "wif": draw((d_in, 2 * cfg.n_heads)),
        "down": draw((d_in, d)),
    }


def _mlstm_gates(params, xm, cfg):
    h = cfg.n_heads
    gates = (xm @ params["wif"]).to(torch.float32)
    li = F.logsigmoid(gates[..., :h])              # log input gate ≤ 0
    lf = F.logsigmoid(gates[..., h:])              # log forget gate ≤ 0
    return li, lf


def mlstm_forward(params, x: torch.Tensor, cfg: ModelConfig,
                  chunk: int = 256) -> torch.Tensor:
    """Chunkwise-parallel mLSTM. x: (B, S, D); S divisible by chunk."""
    b, s, d = x.shape
    nh = cfg.n_heads
    d_in, dh = _mlstm_dims(cfg)
    chunk = min(chunk, s)
    nc = s // chunk
    xz = x @ params["up"]
    xm, z = torch.chunk(xz, 2, dim=-1)
    q = (xm @ params["wq"]).reshape(b, s, nh, dh).to(torch.float32)
    k = (xm @ params["wk"]).reshape(b, s, nh, dh).to(torch.float32) \
        * dh ** -0.5
    v = (xm @ params["wv"]).reshape(b, s, nh, dh).to(torch.float32)
    li, lf = _mlstm_gates(params, xm, cfg)                   # (B,S,H)

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
                                device=x.device))
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
                          device=x.device)
    n_state = torch.zeros((b, nh, dh), dtype=torch.float32, device=x.device)
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
    y = y.reshape(b, s, d_in).to(x.dtype)
    out = y * F.silu(z)
    return out @ params["down"]


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
    q = (xm @ params["wq"]).reshape(b, nh, dh).to(torch.float32)
    k = (xm @ params["wk"]).reshape(b, nh, dh).to(torch.float32) \
        * dh ** -0.5
    v = (xm @ params["wv"]).reshape(b, nh, dh).to(torch.float32)
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
def init_slstm(generator, cfg: ModelConfig, device=None):
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    dev = device if device is not None else generator.device
    w = dense_init(generator, (d, 4 * d), cfg.pdtype, device=device)
    r = dense_init(generator, (nh, dh, 4 * dh), cfg.pdtype, device=device)
    down = dense_init(generator, (d, d), cfg.pdtype, device=device)
    return {
        # Input and recurrent (block-diagonal per head) gate projections.
        "w": w,
        "r": r,
        "b": torch.zeros((4 * d,), dtype=cfg.pdtype, device=dev),
        "down": down,
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
    """Sequential loop over S. x: (B, S, D)."""
    xg = x @ params["w"]                                     # (B,S,4D)
    state = init_slstm_state(x.shape[0], cfg, device=x.device)
    hs = []
    for t in range(x.shape[1]):
        state = _slstm_step(params, cfg, state, xg[:, t])
        hs.append(state.h)
    y = torch.stack(hs, dim=1).to(x.dtype)                   # (B,S,D)
    return y @ params["down"]


def slstm_decode_step(params, x, state: SLSTMState, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, SLSTMState]:
    xg = (x @ params["w"])[:, 0]
    new = _slstm_step(params, cfg, state, xg)
    y = new.h[:, None, :].to(x.dtype)
    return y @ params["down"], new
