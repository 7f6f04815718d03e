"""PyTorch transformer layers: RMSNorm, (partial) RoPE, GQA attention with
optional sliding window and KV cache, SwiGLU FFN, grouped top-k MoE.

Each layer is an ``nn.Module`` that holds its weights under the reference's
names and shapes (``reset_parameters`` draws them from a ``torch.Generator``)
and a plain function on tensors that computes it.  Weights are cast to the
activations' dtype where they are used, as in the reference.

Causal self-attention over default positions runs through the flash
attention kernel (``kernels/flash_attn``, K5); every other attention (the
encoder's, cross attention, decode over the cache, explicit positions or a
key mask) is plain PyTorch.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.flash_attn.flash_attn import DEFAULT_BK, DEFAULT_BQ
from ..kernels.flash_attn.ops import mha_flash
from .config import ArchConfig

ATTN_CHUNK_THRESHOLD = 2048
Q_CHUNK = 512
# the flash-attention wrapper takes S in multiples of its blocks
K5_BLOCK = math.lcm(DEFAULT_BQ, DEFAULT_BK)


def param(shape, device=None, dtype=torch.float32) -> nn.Parameter:
    """An uninitialised weight (it takes gradients in ``loss_fn``; prefill
    and decode run without them)."""
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


def float32(kw: dict) -> dict:
    """``kw`` with float32: the reference builds norms, qkv biases and the
    SSM's constants in float32 whatever the model's dtype."""
    return dict(kw, dtype=torch.float32)


@torch.no_grad()
def dense_init_(w: torch.Tensor, gen: torch.Generator, scale_dim: int,
                mult: float = 1.0) -> None:
    """Fill ``w`` with float32 ``N(0, 1) / sqrt(scale_dim)`` draws (times
    ``mult``), cast to ``w``'s dtype one tensor at a time."""
    draw = torch.randn(w.shape, generator=gen, device=w.device,
                       dtype=torch.float32)
    w.copy_(draw * (mult / math.sqrt(scale_dim)))


# --------------------------------------------------------------------------- #
# norm / rope
# --------------------------------------------------------------------------- #


def rmsnorm(x, w, eps: float):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def _rot(cfg: ArchConfig) -> int:
    rot = int(cfg.hd * cfg.rope_fraction)
    return rot - rot % 2


def rope_freqs(cfg: ArchConfig, positions):
    """positions: [...] int -> (cos, sin) of shape [..., rot/2]."""
    rot = _rot(cfg)
    exps = torch.arange(0, rot, 2, dtype=torch.float32,
                        device=positions.device) / rot
    inv = 1.0 / (cfg.rope_theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin, cfg: ArchConfig):
    """x: [B, S, H, D]; cos/sin: [B, S, rot/2] (broadcast over heads).
    Rotates interleaved pairs ``(x[..., 0::2], x[..., 1::2])``."""
    rot = _rot(cfg)
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    y1 = x1 * c - x2 * s
    y2 = x1 * s + x2 * c
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([yr, xp], dim=-1)


# --------------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------------- #


class Attention(nn.Module):
    """``wq [d, H, hd]``, ``wk``/``wv [d, Hkv, hd]``, ``wo [H, hd, d]`` and,
    with ``qkv_bias``, ``bq``/``bk``/``bv``."""

    def __init__(self, cfg: ArchConfig, device=None, dtype=torch.float32):
        super().__init__()
        d, hd = cfg.d_model, cfg.hd
        kw = dict(device=device, dtype=dtype)
        self.wq = param((d, cfg.n_heads, hd), **kw)
        self.wk = param((d, cfg.n_kv_heads, hd), **kw)
        self.wv = param((d, cfg.n_kv_heads, hd), **kw)
        self.wo = param((cfg.n_heads, hd, d), **kw)
        self.bias = cfg.qkv_bias
        if cfg.qkv_bias:
            self.bq = param((cfg.n_heads, hd), **float32(kw))
            self.bk = param((cfg.n_kv_heads, hd), **float32(kw))
            self.bv = param((cfg.n_kv_heads, hd), **float32(kw))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator, cfg: ArchConfig) -> None:
        for w in (self.wq, self.wk, self.wv):
            dense_init_(w, gen, cfg.d_model)
        dense_init_(self.wo, gen, cfg.n_heads * cfg.hd)
        if self.bias:
            for b in (self.bq, self.bk, self.bv):
                b.zero_()


def _proj(x, w):
    """``einsum('bsd,dhk->bshk')`` as one matmul."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _out(o, wo):
    """``einsum('bqhd,hdo->bqo')`` as one matmul."""
    h, d, m = wo.shape
    return o.flatten(-2) @ wo.to(o.dtype).reshape(h * d, m)


def _qkv(p: Attention, x, cfg: ArchConfig, positions):
    dt = x.dtype
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if cfg.qkv_bias:
        q = q + p.bq.to(dt)
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    cos, sin = rope_freqs(cfg, positions)
    return apply_rope(q, cos, sin, cfg), apply_rope(k, cos, sin, cfg), v


def _expand_kv(k, n_rep: int):
    """[B, S, Hkv, D] -> [B, S, Hkv * n_rep, D]; query head j reads KV head
    j // n_rep."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def flash_causal(q, k, v, window: Optional[int] = None):
    """Causal (optionally windowed) attention of ``[B, S, H, D]`` q, k, v
    (H GQA-expanded) through K5's entry point ``mha_flash``.  S is padded
    with zeros after the sequence up to a multiple of the kernel's blocks:
    under the causal mask a padded key lies after every real query, and the
    padded queries' rows are sliced off."""
    S = q.shape[1]
    pad = -S % K5_BLOCK
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    out = mha_flash(q, k, v, window=window)
    return out[:, :S] if pad else out


def _mask(qpos, kpos, cfg: ArchConfig, causal: bool, kv_mask=None):
    """[B, 1, Sq, Sk] keep-mask of queries at ``qpos`` over keys at
    ``kpos``: causal, the sliding window, the key mask."""
    idx_q = qpos[:, None, :, None]
    idx_k = kpos[:, None, None, :]
    mask = torch.ones((1, 1, 1, 1), dtype=torch.bool, device=qpos.device)
    if causal:
        mask = mask & (idx_k <= idx_q)
    if cfg.sliding_window is not None:
        mask = mask & (idx_k > idx_q - cfg.sliding_window)
    if kv_mask is not None:
        mask = mask & kv_mask[:, None, None, :]
    return mask


def _softmax_attend(q, k, v, cfg: ArchConfig, mask=None):
    """Plain attention of q [B, Sq, H, D] over k, v [B, Sk, H, D]: float32
    scores of the activations' dtype product, scaled, masked to -1e30,
    softmax in float32, probabilities cast back before P V."""
    scale = 1.0 / math.sqrt(cfg.hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _attend(q, k, v, cfg: ArchConfig, qpos=None, kpos=None,
            causal: bool = False, kv_mask=None):
    """:func:`_softmax_attend` (masked by :func:`_mask` unless ``qpos`` is
    None), over query chunks of ``Q_CHUNK`` when there are more than
    ``ATTN_CHUNK_THRESHOLD`` queries, so the scores held at once are
    ``[B, H, Q_CHUNK, Sk]``: the function of the reference's
    ``_attention_chunked`` and ``_attention_chunked_scan``."""
    S = q.shape[1]
    step = S if S <= ATTN_CHUNK_THRESHOLD else Q_CHUNK
    outs = []
    for a in range(0, S, step):
        mask = None if qpos is None else _mask(qpos[:, a:a + step], kpos, cfg,
                                               causal, kv_mask)
        outs.append(_softmax_attend(q[:, a:a + step], k, v, cfg, mask))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def attention(p: Attention, x, cfg: ArchConfig, *, causal: bool = True,
              positions=None, kv_mask=None):
    """Full (or sliding-window) self-attention over x: [B, S, D].

    Causal attention over default positions with no key mask (what the
    decoder blocks of ``prefill`` and ``loss_fn`` call) runs K5
    (:func:`flash_causal`); the rest is plain PyTorch (:func:`_attend`)."""
    B, S, _ = x.shape
    k5 = causal and positions is None and kv_mask is None
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _qkv(p, x, cfg, positions)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    k, v = _expand_kv(k, n_rep), _expand_kv(v, n_rep)
    if k5:
        out = flash_causal(q, k, v, window=cfg.sliding_window)
    else:
        out = _attend(q, k, v, cfg, positions, positions, causal, kv_mask)
    return _out(out, p.wo)


def cross_attention(p: Attention, x, kv_src, cfg: ArchConfig):
    """Encoder-decoder cross attention (no RoPE, no mask); long query
    sequences go through the chunked path."""
    q, k, v = _proj(x, p.wq), _proj(kv_src, p.wk), _proj(kv_src, p.wv)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    k, v = _expand_kv(k, n_rep), _expand_kv(v, n_rep)
    return _out(_attend(q, k, v, cfg), p.wo)


def attention_decode(p: Attention, x, cache_k, cache_v, kv_pos,
                     write_slot: int, q_pos: int, cfg: ArchConfig):
    """One-token decode with a (possibly ring-buffered) KV cache, written in
    place.

    x: [B, 1, D]; cache_k/v: [B, S_cache, Hkv, D]; kv_pos: [S_cache] — the
    absolute position held by each slot after this write (-1 = empty);
    write_slot: the slot of the new token; q_pos: its absolute position.
    The query heads' groups fold into the products, so the cache is read at
    ``n_kv_heads`` and never expanded."""
    B = x.shape[0]
    pos = torch.full((B, 1), q_pos, dtype=torch.long, device=x.device)
    q, k, v = _qkv(p, x, cfg, pos)
    cache_k[:, write_slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, write_slot] = v[:, 0].to(cache_v.dtype)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(B, 1, cfg.n_kv_heads, n_rep, cfg.hd)
    scale = 1.0 / math.sqrt(cfg.hd)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg,
                          cache_k.to(q.dtype)).float() * scale
    mask = (kv_pos >= 0) & (kv_pos <= q_pos)
    if cfg.sliding_window is not None:
        mask &= kv_pos > q_pos - cfg.sliding_window
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, cache_v.to(x.dtype))
    return _out(out.reshape(B, 1, cfg.n_heads, cfg.hd), p.wo)


# --------------------------------------------------------------------------- #
# FFN
# --------------------------------------------------------------------------- #


class SwiGLU(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.w_gate = param((cfg.d_model, cfg.d_ff), **kw)
        self.w_up = param((cfg.d_model, cfg.d_ff), **kw)
        self.w_down = param((cfg.d_ff, cfg.d_model), **kw)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator, cfg: ArchConfig) -> None:
        dense_init_(self.w_gate, gen, cfg.d_model)
        dense_init_(self.w_up, gen, cfg.d_model)
        dense_init_(self.w_down, gen, cfg.d_ff)


def swiglu(p: SwiGLU, x):
    dt = x.dtype
    h = F.silu(x @ p.w_gate.to(dt)) * (x @ p.w_up.to(dt))
    return h @ p.w_down.to(dt)


# --------------------------------------------------------------------------- #
# MoE (token-choice top-k with GShard-style grouped dispatch)
# --------------------------------------------------------------------------- #


class MoE(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None, dtype=torch.float32):
        super().__init__()
        E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
        kw = dict(device=device, dtype=dtype)
        self.router = param((d, E), **kw)
        self.w_gate = param((E, d, f), **kw)
        self.w_up = param((E, d, f), **kw)
        self.w_down = param((E, f, d), **kw)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator, cfg: ArchConfig) -> None:
        for w in (self.router, self.w_gate, self.w_up):
            dense_init_(w, gen, cfg.d_model)
        dense_init_(self.w_down, gen, cfg.d_ff)


def moe_ffn(p: MoE, x, cfg: ArchConfig):
    """x: [B, S, D] -> top-k expert mixture.  Tokens are processed in groups
    of ``group_size`` with a per-group expert capacity (GShard); a (token,
    k) pair takes the next slot of its expert in (token, k) order, and
    pairs past the capacity are dropped."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    G = max(T // m.group_size, 1)
    xt = x.reshape(G, T // G, D)
    Tg = xt.shape[1]
    cap = max(int(math.ceil(m.top_k * Tg / m.num_experts * m.capacity_factor)), 4)
    dt = x.dtype

    logits = (xt @ p.router.to(dt)).float()
    probs = torch.softmax(logits, dim=-1)
    # bf16 router logits tie often; a stable sort takes the lower expert
    # first, as ``lax.top_k`` does
    gate_vals, top_e = (t[..., :m.top_k] for t in torch.sort(
        probs, dim=-1, descending=True, stable=True))  # [G, Tg, K]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)

    # position of each (token, k) within its expert's capacity buffer
    onehot_i = F.one_hot(top_e, m.num_experts)  # [G, Tg, K, E]
    flat = onehot_i.reshape(G, Tg * m.top_k, m.num_experts)
    pos_in_e = torch.cumsum(flat, dim=1) - flat
    pos = (pos_in_e * flat).sum(-1).reshape(G, Tg, m.top_k)
    keep = (pos < cap) & (gate_vals > 0)

    onehot_e = torch.where(keep[..., None], onehot_i, 0).to(dt)  # [G,Tg,K,E]
    onehot_c = F.one_hot(torch.where(keep, pos, cap), cap + 1).to(dt)[..., :cap]
    disp = torch.einsum("gtke,gtkc->gtec", onehot_e, onehot_c)  # [G,Tg,E,C]
    expert_in = torch.einsum("gtec,gtd->gecd", disp, xt)

    h = F.silu(torch.einsum("gecd,edf->gecf", expert_in, p.w_gate.to(dt)))
    h = h * torch.einsum("gecd,edf->gecf", expert_in, p.w_up.to(dt))
    out_e = torch.einsum("gecf,efd->gecd", h, p.w_down.to(dt))

    gated_e = onehot_e * torch.where(keep, gate_vals, 0.0).to(dt)[..., None]
    combine = torch.einsum("gtke,gtkc->gtec", gated_e, onehot_c)
    out = torch.einsum("gtec,gecd->gtd", combine, out_e)
    return out.reshape(B, S, D)
