"""State-space and recurrent blocks: the Mamba-style selective SSM of
hymba's parallel SSM heads, and xLSTM's mLSTM and sLSTM blocks.

Each recurrence is a loop over time in float32.  Decode is O(1) per token:
the carry (SSM state, matrix memory) is the only state.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn

from ..distrib.sharding import local_call
from .config import ArchConfig
from .layers import _proj, dense_init_, float32, param


def _mm(x, w):
    return x @ w.to(x.dtype)


def _on_shards(fn, p: nn.Module, x, cfg: ArchConfig, state=None):
    """``fn(p, x, cfg)``, or ``fn(p, x, state, cfg) -> (y, state)``, of a
    recurrent block.  On DTensors (the loops over time have no DTensor
    rule) each rank runs its own batch rows (the data axes) with the
    block's weights and the state redistributed to ``Replicate`` over the
    other axes."""
    names = [n for n, _ in p.named_parameters(recurse=False)]
    ws = [getattr(p, n) for n in names]
    act = ("batch", "seq", "embed")
    if state is None:
        def local(x, *ws):
            return fn(SimpleNamespace(**dict(zip(names, ws))), x, cfg)

        return local_call(local, (x, *ws), (act,) + ((),) * len(ws),
                          (tuple(x.shape), act))
    st = list(state) if isinstance(state, tuple) else [state]
    n = len(st)

    def local(x, *rest):
        s = tuple(rest[:n]) if isinstance(state, tuple) else rest[0]
        y, s = fn(SimpleNamespace(**dict(zip(names, rest[n:]))), x, s, cfg)
        return (y, *(s if isinstance(state, tuple) else (s,)))

    def rows(t):
        return ("batch",) + (None,) * (t.ndim - 1)

    y, *new = local_call(local, (x, *st, *ws),
                         (act, *map(rows, st)) + ((),) * len(ws),
                         [(tuple(x.shape), act)]
                         + [(tuple(t.shape), rows(t)) for t in st])
    return y, (tuple(new) if isinstance(state, tuple) else new[0])


# --------------------------------------------------------------------------- #
# Mamba-style selective SSM
# --------------------------------------------------------------------------- #


class Mamba(nn.Module):
    SPECS = {"w_in": ("embed", "mlp"), "conv_w": ("conv", "mlp"),
             "w_bc": ("mlp", None), "w_dt": ("mlp", "mlp"),
             "A_log": ("mlp", "state"), "D": ("mlp",), "w_out": ("mlp", "embed")}

    def __init__(self, cfg: ArchConfig, device=None, dtype=torch.float32):
        super().__init__()
        m = cfg.ssm
        d_in, N = m.expand * cfg.d_model, m.state_dim
        kw = dict(device=device, dtype=dtype)
        self.w_in = param((cfg.d_model, 2 * d_in), **kw)
        self.conv_w = param((m.conv_width, d_in), **float32(kw))
        self.w_bc = param((d_in, 2 * N), **kw)
        self.w_dt = param((d_in, d_in), **kw)
        self.A_log = param((d_in, N), **float32(kw))
        self.D = param((d_in,), **float32(kw))
        self.w_out = param((d_in, cfg.d_model), **kw)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator, cfg: ArchConfig) -> None:
        d_in, N = self.D.shape[0], self.A_log.shape[1]
        dense_init_(self.w_in, gen, cfg.d_model)
        dense_init_(self.conv_w, gen, 1, mult=0.1)
        dense_init_(self.w_bc, gen, d_in)
        dense_init_(self.w_dt, gen, d_in)
        a = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                   device=self.A_log.device))
        self.A_log.copy_(a.expand(d_in, N))
        self.D.fill_(1.0)
        dense_init_(self.w_out, gen, d_in)


def _mamba_inputs(p: Mamba, x, cfg: ArchConfig):
    m = cfg.ssm
    d_in = m.expand * cfg.d_model
    dt_ = x.dtype
    xz = _mm(x, p.w_in)
    xs, z = xz[..., :d_in], xz[..., d_in:]
    # depthwise causal conv via shifts (width w)
    S = xs.shape[1]
    conv = torch.zeros_like(xs)
    for k in range(m.conv_width):
        shifted = F.pad(xs, (0, 0, k, 0))[:, :S, :]
        conv = conv + shifted * p.conv_w[k].to(dt_)
    xs = F.silu(conv)
    bc = _mm(xs, p.w_bc).float()
    B_, C_ = bc[..., :m.state_dim], bc[..., m.state_dim:]
    dt = F.softplus(_mm(xs, p.w_dt).float())
    return xs, z, B_, C_, dt


def mamba_forward(p: Mamba, x, cfg: ArchConfig):
    """x: [B, S, D] -> [B, S, D] (prefill).  The decay and input terms of
    every step are formed at once; the loop carries ``h = decay * h + u``."""
    return _on_shards(_mamba_forward, p, x, cfg)


def _mamba_forward(p, x, cfg: ArchConfig):
    xs, z, B_, C_, dt = _mamba_inputs(p, x, cfg)
    A = -torch.exp(p.A_log)  # [dI, N]
    # time-major [S, B, dI, N]
    dt_t = dt.transpose(0, 1)
    decay = torch.exp(dt_t[..., None] * A)
    u = (dt_t * xs.transpose(0, 1).float())[..., None] * B_.transpose(0, 1)[:, :, None, :]
    hs = _mamba_scan(u, decay)
    del decay, u
    ys = torch.einsum("sbdn,sbn->sbd", hs, C_.transpose(0, 1))
    y = ys.transpose(0, 1).to(x.dtype) + xs * p.D.to(x.dtype)
    y = y * F.silu(z)
    return _mm(y, p.w_out)


def _mamba_scan(u, decay):
    """Every ``h_t = decay_t * h_{t-1} + u_t`` of a time-major [S, ...]
    sequence, from ``h_{-1} = 0``."""
    h = torch.zeros_like(u[0])
    if torch.is_grad_enabled():  # autograd takes no ``out=`` writes
        steps = []
        for t in range(u.shape[0]):
            h = torch.addcmul(u[t], decay[t], h)
            steps.append(h)
        return torch.stack(steps)
    hs = torch.empty_like(u)
    for t in range(u.shape[0]):
        h = torch.addcmul(u[t], decay[t], h, out=hs[t])
    return hs


def mamba_decode(p: Mamba, x, state, cfg: ArchConfig):
    """One token: x [B, 1, D], state [B, dI, N] -> (y [B, 1, D], new state).
    The causal conv sees this one step only, as in the reference."""
    return _on_shards(_mamba_decode, p, x, cfg, state)


def _mamba_decode(p, x, state, cfg: ArchConfig):
    xs, z, B_, C_, dt = _mamba_inputs(p, x, cfg)
    A = -torch.exp(p.A_log)
    x_t, b_t, c_t, dt_t = xs[:, 0], B_[:, 0], C_[:, 0], dt[:, 0]
    decay = torch.exp(dt_t[..., None] * A[None])
    state = decay * state + (dt_t * x_t.float())[..., None] * b_t[:, None, :]
    y = torch.einsum("bdn,bn->bd", state, c_t)[:, None, :].to(x.dtype)
    y = y + xs * p.D.to(x.dtype)
    y = y * F.silu(z)
    return _mm(y, p.w_out), state


# --------------------------------------------------------------------------- #
# mLSTM (xLSTM matrix-memory block)
# --------------------------------------------------------------------------- #


class MLSTM(nn.Module):
    SPECS = {"w_up": ("embed", "mlp"), "wq": ("mlp", "heads", None),
             "wk": ("mlp", "heads", None), "wv": ("mlp", "heads", None),
             "w_if": ("mlp", None), "w_o": ("embed", "mlp"),
             "w_down": ("mlp", "embed")}

    def __init__(self, cfg: ArchConfig, device=None, dtype=torch.float32):
        super().__init__()
        H, d = cfg.n_heads, cfg.d_model
        d_in = 2 * d
        dh = d_in // H
        kw = dict(device=device, dtype=dtype)
        self.w_up = param((d, d_in), **kw)
        self.wq = param((d_in, H, dh), **kw)
        self.wk = param((d_in, H, dh), **kw)
        self.wv = param((d_in, H, dh), **kw)
        self.w_if = param((d_in, 2 * H), **kw)
        self.w_o = param((d, d_in), **kw)
        self.w_down = param((d_in, d), **kw)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator, cfg: ArchConfig) -> None:
        d_in = 2 * cfg.d_model
        dense_init_(self.w_up, gen, cfg.d_model)
        for w in (self.wq, self.wk, self.wv, self.w_if):
            dense_init_(w, gen, d_in)
        dense_init_(self.w_o, gen, cfg.d_model)
        dense_init_(self.w_down, gen, d_in)


def _mlstm_qkv(p: MLSTM, x, cfg: ArchConfig):
    H = cfg.n_heads
    inner = _mm(x, p.w_up)
    norm = math.sqrt(p.wq.shape[-1])
    q = _proj(inner, p.wq) / norm
    k = _proj(inner, p.wk) / norm
    v = _proj(inner, p.wv)
    gates = _mm(inner, p.w_if).float()
    log_i, log_f = gates[..., :H], F.logsigmoid(gates[..., H:])
    og = torch.sigmoid(_mm(x, p.w_o))
    return q, k, v, log_i, log_f, og


def _mlstm_step(state, q_t, k_t, v_t, li_t, lf_t):
    C, n, m = state  # [B,H,dh,dh], [B,H,dh], [B,H]
    m_new = torch.maximum(lf_t + m, li_t)
    i_p = torch.exp(li_t - m_new)
    f_p = torch.exp(lf_t + m - m_new)
    k32, q32 = k_t.float(), q_t.float()
    C = f_p[..., None, None] * C + i_p[..., None, None] * (
        k32[..., :, None] * v_t.float()[..., None, :])
    n = f_p[..., None] * n + i_p[..., None] * k32
    num = torch.einsum("bhkv,bhk->bhv", C, q32)
    den = torch.einsum("bhk,bhk->bh", n, q32).abs().clamp(min=1.0)
    return (C, n, m_new), num / den[..., None]


def mlstm_state(cfg: ArchConfig, batch: int, device=None):
    """The zero state: matrix memory, normaliser, stabiliser at -1e30."""
    H = cfg.n_heads
    dh = 2 * cfg.d_model // H
    kw = dict(dtype=torch.float32, device=device)
    return (torch.zeros((batch, H, dh, dh), **kw),
            torch.zeros((batch, H, dh), **kw),
            torch.full((batch, H), -1e30, **kw))


def mlstm_forward(p: MLSTM, x, cfg: ArchConfig):
    """Exponential-gated matrix memory, a loop over the sequence."""
    return _on_shards(_mlstm_forward, p, x, cfg)


def _mlstm_forward(p, x, cfg: ArchConfig):
    q, k, v, log_i, log_f, og = _mlstm_qkv(p, x, cfg)
    B, S, H, dh = q.shape
    ys = _mlstm_scan(mlstm_state(cfg, B, x.device), q, k, v, log_i, log_f)
    y = ys.reshape(B, S, H * dh).to(x.dtype) * og
    return _mm(y, p.w_down)


def _mlstm_scan(state, q, k, v, log_i, log_f):
    """The matrix memory's outputs [B, S, H, dh], one step a position."""
    ys = []
    for t in range(q.shape[1]):
        state, y = _mlstm_step(state, q[:, t], k[:, t], v[:, t], log_i[:, t],
                               log_f[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1)


def mlstm_decode(p: MLSTM, x, state, cfg: ArchConfig):
    return _on_shards(_mlstm_decode, p, x, cfg, state)


def _mlstm_decode(p, x, state, cfg: ArchConfig):
    q, k, v, log_i, log_f, og = _mlstm_qkv(p, x, cfg)
    state, y = _mlstm_step(state, *(a[:, 0] for a in (q, k, v, log_i, log_f)))
    B, _, H, dh = q.shape
    y = y.reshape(B, 1, H * dh).to(x.dtype) * og
    return _mm(y, p.w_down), state


# --------------------------------------------------------------------------- #
# sLSTM (xLSTM scalar-memory block)
# --------------------------------------------------------------------------- #


class SLSTM(nn.Module):
    SPECS = {"w_gates": ("embed", "mlp"), "r_gates": ("embed", "mlp"),
             "w_down": ("embed", "embed")}

    def __init__(self, cfg: ArchConfig, device=None, dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        kw = dict(device=device, dtype=dtype)
        self.w_gates = param((d, 4 * d), **kw)  # i, f, z, o from x
        self.r_gates = param((d, 4 * d), **kw)  # recurrent, from h
        self.w_down = param((d, d), **kw)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator, cfg: ArchConfig) -> None:
        dense_init_(self.w_gates, gen, cfg.d_model)
        dense_init_(self.r_gates, gen, cfg.d_model, mult=0.1)
        dense_init_(self.w_down, gen, cfg.d_model)


def _slstm_step(p: SLSTM, state, g_t, dt_, d: int):
    c, n, m, h = state
    g = g_t + _mm(h.to(dt_), p.r_gates).float()
    li = g[..., :d]
    lf = F.logsigmoid(g[..., d:2 * d])
    z = torch.tanh(g[..., 2 * d:3 * d])
    o = torch.sigmoid(g[..., 3 * d:])
    m_new = torch.maximum(lf + m, li)
    i_p = torch.exp(li - m_new)
    f_p = torch.exp(lf + m - m_new)
    c = f_p * c + i_p * z
    n = (f_p * n + i_p).clamp(min=1.0)
    h = o * c / n
    return c, n, m_new, h


def slstm_state(cfg: ArchConfig, batch: int, device=None):
    """The zero state (c, n = 1, stabiliser at -1e30, h)."""
    z = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return z, torch.ones_like(z), torch.full_like(z, -1e30), z.clone()


def slstm_forward(p: SLSTM, x, cfg: ArchConfig):
    return _on_shards(_slstm_forward, p, x, cfg)


def _slstm_forward(p, x, cfg: ArchConfig):
    gx = _mm(x, p.w_gates).float()
    hs = _slstm_scan(p, slstm_state(cfg, x.shape[0], x.device), gx, x.dtype,
                     cfg.d_model)
    return _mm(hs.to(x.dtype), p.w_down)


def _slstm_scan(p, state, gx, dt_, d: int):
    """The hidden states [B, S, d], one step a position."""
    hs = []
    for t in range(gx.shape[1]):
        state = _slstm_step(p, state, gx[:, t], dt_, d)
        hs.append(state[3])
    return torch.stack(hs, dim=1)


def slstm_decode(p: SLSTM, x, state, cfg: ArchConfig):
    return _on_shards(_slstm_decode, p, x, cfg, state)


def _slstm_decode(p, x, state, cfg: ArchConfig):
    gx = _mm(x, p.w_gates).float()[:, 0]
    state = _slstm_step(p, state, gx, x.dtype, cfg.d_model)
    return _mm(state[3][:, None, :].to(x.dtype), p.w_down), state
