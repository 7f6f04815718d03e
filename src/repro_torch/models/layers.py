"""PyTorch transformer layers: RMSNorm, (partial) RoPE, GQA attention with
optional sliding window and KV cache, SwiGLU FFN, grouped top-k MoE.

Each layer is an ``nn.Module`` that holds its weights under the reference's
names and shapes (``reset_parameters`` draws them from a ``torch.Generator``)
and a plain function on tensors that computes it.  Weights are cast to the
activations' dtype where they are used, as in the reference.

Causal self-attention over default positions runs through the flash
attention kernel (``kernels/flash_attn``, K5); every other attention (the
encoder's, cross attention, decode over the cache, explicit positions or a
key mask) is plain PyTorch.  RMSNorm runs through its kernel pair
(``kernels/rmsnorm``), on a mesh each rank on its own rows.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..compat import DTensor, Partial, Replicate, Shard
from ..distrib.sharding import (current_rules, local_call, placements,
                                replicate_like, shard, spec_for)
from ..kernels.flash_attn.flash_attn import DEFAULT_BK, DEFAULT_BQ
from ..kernels.flash_attn.ops import mha_flash
from ..kernels.rmsnorm.ops import rmsnorm as rmsnorm_kernel
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


class _MeshNorm(torch.autograd.Function):
    """RMSNorm of a DTensor: each rank runs the kernels' wrapper on its own
    rows with the last dim whole (x made whole along it and summed where
    it is a partial sum; w whole), and differentiates it there, the
    forward run again in the backward.  The backward is linear in the
    output's gradient, so where that gradient is a partial sum over a mesh
    dim it stays one: each rank's dx and dw of its own part, summed later,
    as DTensor's own ops would."""

    @staticmethod
    def forward(ctx, x, w, eps):
        mesh, last = x.device_mesh, x.ndim - 1
        pl = tuple(Replicate() if p.is_partial() or (p.is_shard() and p.dim in (-1, last))
                   else p for p in x.placements)
        xl = x.redistribute(mesh, pl).to_local()
        wl = w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
        ctx.save_for_backward(xl, wl)
        ctx.eps, ctx.mesh, ctx.pl, ctx.w_pl = eps, mesh, pl, w.placements
        ctx.meta = (x.shape, x.stride(), w.shape, w.stride())
        return DTensor.from_local(rmsnorm_kernel(xl, wl, eps), mesh, pl, run_check=False,
                                  shape=x.shape, stride=x.stride())

    @staticmethod
    def backward(ctx, g):
        x_shape, x_stride, w_shape, w_stride = ctx.meta
        # a partial sum stays one where x is whole on that mesh dim
        gpl = tuple(p if p.is_partial() and q.is_replicate() else q
                    for p, q in zip(g.placements, ctx.pl))
        xl, wl = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            dx, dw = torch.autograd.grad(rmsnorm_kernel(xl, wl, ctx.eps), (xl, wl),
                                         g.redistribute(ctx.mesh, gpl).to_local())
        # dw sums the rows: partial over each dim that splits them or g
        dw_pl = [Partial() if p.is_partial() or p.is_shard() else Replicate() for p in gpl]
        dw = DTensor.from_local(dw, ctx.mesh, dw_pl, run_check=False, shape=w_shape,
                                stride=w_stride).redistribute(ctx.mesh, ctx.w_pl)
        return (DTensor.from_local(dx, ctx.mesh, gpl, run_check=False, shape=x_shape,
                                   stride=x_stride), dw, None)


def rmsnorm(x, w, eps: float):
    """RMSNorm of the residual stream ``x [..., d]``: the kernel pair of
    ``kernels/rmsnorm`` (on real CPU tensors its plain version, the eager
    op); DTensors, on every device, through :class:`_MeshNorm`, which runs
    the same wrapper on each rank's rows."""
    if isinstance(x, DTensor):
        return _MeshNorm.apply(x, w, eps)
    return rmsnorm_kernel(x, w, eps)


def _rot(cfg: ArchConfig) -> int:
    rot = int(cfg.hd * cfg.rope_fraction)
    return rot - rot % 2


def rope_freqs(cfg: ArchConfig, positions):
    """positions: [...] int -> (cos, sin) of shape [..., rot/2]."""
    rot = _rot(cfg)
    exps = torch.arange(0, rot, 2, dtype=torch.float32,
                        device=positions.device) / rot
    inv = replicate_like(positions, 1.0 / (cfg.rope_theta ** exps))
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

    SPECS = {"wq": ("embed", "heads", None), "wk": ("embed", "kv_heads", None),
             "wv": ("embed", "kv_heads", None), "wo": ("heads", None, "embed"),
             "bq": ("heads", None), "bk": ("kv_heads", None),
             "bv": ("kv_heads", None)}

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


def _merged(t, shape, logical, dim: int):
    """A DTensor ``t`` that is ``shape`` with dims ``dim`` and ``dim + 1``
    merged, in the layout of ``logical`` over ``shape``: the merged dim is
    sharded only where its first part (the heads) divides the mesh, so its
    split into heads, and the backward's, never meets an uneven shard.
    Plain tensors pass through."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    spec = spec_for(mesh, shape, logical)
    flat = spec[:dim + 1] + spec[dim + 2:]
    return t.redistribute(mesh, placements(mesh, flat))


def _proj(x, w, heads: str = "heads"):
    """``einsum('bsd,dhk->bshk')`` as one matmul (``heads`` names the
    weight's head dim for the sharding rules)."""
    d, h, k = w.shape
    w2 = _merged(w.to(x.dtype).reshape(d, h * k), (d, h, k),
                 ("embed", heads, None), 1)
    y = _merged(x @ w2, (*x.shape[:-1], h, k), ("batch", "seq", heads, None), 2)
    return y.unflatten(-1, (h, k))


def _out(o, wo):
    """``einsum('bqhd,hdo->bqo')`` as one matmul."""
    h, d, m = wo.shape
    o2 = _merged(o.flatten(-2), o.shape, ("batch", "seq", "heads", None), 2)
    wo2 = _merged(wo.to(o.dtype).reshape(h * d, m), wo.shape,
                  ("heads", None, "embed"), 0)
    return o2 @ wo2


def _qkv(p: Attention, x, cfg: ArchConfig, positions):
    dt = x.dtype
    q = _proj(x, p.wq)
    k, v = _proj(x, p.wk, "kv_heads"), _proj(x, p.wv, "kv_heads")
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


def embedding(tokens, table):
    """``F.embedding``; on DTensors each rank looks its own tokens up in
    the whole table (redistributed to ``Replicate``)."""
    return local_call(F.embedding, (tokens, table), (("batch", "seq"), ()),
                      (tuple(tokens.shape) + (table.shape[1],),
                       ("batch", "seq", None)))


def flash_causal(q, k, v, window: Optional[int] = None):
    """Causal (optionally windowed) attention of ``[B, S, H, D]`` q, k, v
    (H GQA-expanded) through K5's entry point ``mha_flash``.  S is padded
    with zeros after the sequence up to a multiple of the kernel's blocks:
    under the causal mask a padded key lies after every real query, and the
    padded queries' rows are sliced off.

    On DTensors the kernel cannot take the sharded tensor: each rank runs
    it on its own ``[B_local, S, H_local, D]`` (batch over the data axes,
    heads over ``model`` where they divide it, else all heads on every
    rank; the sequence whole), and K5's backward kernel runs on the same
    shards."""
    spec = ("batch", None, "heads", None)
    return local_call(lambda a, b, c: _flash_local(a, b, c, window),
                      (q, k, v), (spec, spec, spec), (tuple(q.shape), spec))


def _flash_local(q, k, v, window: Optional[int] = None):
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
        positions = replicate_like(x, torch.arange(S, device=x.device)[None])
    q, k, v = _qkv(p, x, cfg, positions)
    # "seq_q" (None by default) shards queries over positions when the
    # heads do not divide the model axis
    seq_name = "seq_q" if current_rules().get("seq_q") else "seq"
    q = shard(q, "batch", seq_name, "heads", None)
    k = shard(k, "batch", "seq", "kv_heads", None)
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
    q = _proj(x, p.wq)
    k, v = _proj(kv_src, p.wk, "kv_heads"), _proj(kv_src, p.wv, "kv_heads")
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
    ``n_kv_heads`` and never expanded.  On DTensors each rank writes the
    slots and heads it holds, and attends with its own batch rows over the
    whole cache (gathered over slots, and over heads unless the KV heads
    divide the model axis)."""
    pos = torch.full((1, 1), q_pos, dtype=torch.long, device=x.device)
    q, k, v = _qkv(p, x, cfg, replicate_like(x, pos))
    write_slot_(cache_k, write_slot, k[:, 0])
    write_slot_(cache_v, write_slot, v[:, 0])
    by_heads = isinstance(cache_k, DTensor) and any(
        pl.is_shard(2) for pl in cache_k.placements)
    q_lg = ("batch", None, "heads" if by_heads else None, None)
    c_lg = ("batch", None, "kv_heads" if by_heads else None, None)
    out = local_call(
        lambda q, ck, cv, kp: _decode_attend(q, ck, cv, kp, q_pos, cfg),
        (q, cache_k, cache_v, kv_pos), (q_lg, c_lg, c_lg, ()),
        (tuple(q.shape), q_lg))
    return _out(out, p.wo)


def _decode_attend(q, cache_k, cache_v, kv_pos, q_pos: int, cfg: ArchConfig):
    B, _, H, hd = q.shape
    Hkv = cache_k.shape[2]
    qg = q.reshape(B, 1, Hkv, H // Hkv, hd)
    scale = 1.0 / math.sqrt(cfg.hd)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg,
                          cache_k.to(q.dtype)).float() * scale
    mask = (kv_pos >= 0) & (kv_pos <= q_pos)
    if cfg.sliding_window is not None:
        mask &= kv_pos > q_pos - cfg.sliding_window
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, cache_v.to(q.dtype))
    return out.reshape(B, 1, H, hd)


def local_view(t):
    """The part of ``t`` this rank holds, as a view that writes through."""
    return t.to_local() if isinstance(t, DTensor) else t


def assign_(dst, src) -> None:
    """``dst.copy_(src)``; a DTensor ``src`` is first redistributed to
    ``dst``'s layout and each rank writes its own part."""
    if isinstance(dst, DTensor):
        src = src.redistribute(dst.device_mesh, dst.placements)
    local_view(dst).copy_(local_view(src))


def write_slot_(cache, slot: int, new) -> None:
    """``cache[:, slot] = new`` (cache [B, S, H, D], new [B, H, D]); on a
    DTensor cache, by the ranks that hold the slot, each its own rows and
    heads."""
    if not isinstance(cache, DTensor):
        cache[:, slot] = new.to(cache.dtype)
        return
    mesh = cache.device_mesh
    # the cache's layout without its slot dim
    want = [Replicate() if pl.is_shard(1) else
            Shard(pl.dim - 1) if pl.is_shard() and pl.dim > 1 else pl
            for pl in cache.placements]
    src = new.redistribute(mesh, want).to_local()
    local = cache.to_local()
    idx = 0  # which block of slots this rank holds
    for j, pl in enumerate(cache.placements):
        if pl.is_shard(1):
            idx = idx * mesh.size(j) + mesh.get_local_rank(j)
    lo = idx * local.shape[1]
    if lo <= slot < lo + local.shape[1]:
        local[:, slot - lo] = src.to(local.dtype)


# --------------------------------------------------------------------------- #
# FFN
# --------------------------------------------------------------------------- #


class SwiGLU(nn.Module):
    SPECS = {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
             "w_down": ("mlp", "embed")}

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
    h = shard(h, "batch", "seq", "mlp")
    return h @ p.w_down.to(dt)


# --------------------------------------------------------------------------- #
# MoE (token-choice top-k with GShard-style grouped dispatch)
# --------------------------------------------------------------------------- #


class MoE(nn.Module):
    SPECS = {"router": ("embed", None), "w_gate": ("experts", "embed", "mlp"),
             "w_up": ("experts", "embed", "mlp"),
             "w_down": ("experts", "mlp", "embed")}

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
    pairs past the capacity are dropped.

    On DTensors (top-k and the capacity scatter have no DTensor rule) each
    rank runs its own token groups (batch over the data axes) against its
    slice of the experts' ``mlp`` dim (and of the experts, when a rule
    shards them), the layout of the reference's two ``shard`` calls here;
    the output is a partial sum over ``model``.  Where a rank's own tokens
    do not make whole groups of the global batch (decode, small batches),
    every rank routes all the tokens, so groups and capacities stay the
    global ones, and keeps its own rows of the output."""
    tokens = ("batch", "seq", "embed")
    whole = not isinstance(x, DTensor) or _local_groups(x, cfg)
    routed = tokens if whole else (None, "seq", "embed")
    out = local_call(lambda *a: _moe_local(*a, cfg),
                     (x, p.router, p.w_gate, p.w_up, p.w_down),
                     (routed, (), MoE.SPECS["w_gate"], MoE.SPECS["w_up"],
                      MoE.SPECS["w_down"]),
                     (tuple(x.shape), routed))
    if whole:
        return out
    mesh = out.device_mesh
    rows = placements(mesh, spec_for(mesh, x.shape, tokens))
    return out.redistribute(mesh, [r if r.is_shard() else pl for r, pl
                                   in zip(rows, out.placements)])


def _groups(T: int, group_size: int) -> int:
    """The tokens in each GShard group (``Tg``) when ``T`` tokens are
    routed in groups of ``group_size``."""
    return T // max(T // group_size, 1)


def _local_groups(x, cfg: ArchConfig) -> bool:
    """Whether each rank's batch rows of ``x`` are whole token groups of
    the global batch, formed as the global batch forms them."""
    mesh = x.device_mesh
    B, S, _ = x.shape
    n = math.prod(mesh.size(j) for j, pl in enumerate(
        placements(mesh, spec_for(mesh, x.shape, ("batch",)))) if pl.is_shard())
    gs, T = cfg.moe.group_size, B * S
    tg, tl = _groups(T, gs), T // n
    return tl % tg == 0 and tl // tg == max(tl // gs, 1)


def _moe_local(x, router, w_gate, w_up, w_down, cfg: ArchConfig):
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    G = max(T // m.group_size, 1)
    xt = x.reshape(G, T // G, D)
    Tg = xt.shape[1]
    cap = max(int(math.ceil(m.top_k * Tg / m.num_experts * m.capacity_factor)), 4)
    dt = x.dtype

    logits = (xt @ router.to(dt)).float()
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
    # G (token groups) stays sharded over the data-parallel axes
    expert_in = shard(expert_in, "batch", "experts", None, "embed")

    h = F.silu(torch.einsum("gecd,edf->gecf", expert_in, w_gate.to(dt)))
    h = h * torch.einsum("gecd,edf->gecf", expert_in, w_up.to(dt))
    h = shard(h, "batch", "experts", None, "mlp")
    out_e = torch.einsum("gecf,efd->gecd", h, w_down.to(dt))

    gated_e = onehot_e * torch.where(keep, gate_vals, 0.0).to(dt)[..., None]
    combine = torch.einsum("gtke,gtkc->gtec", gated_e, onehot_c)
    out = torch.einsum("gtec,gecd->gtd", combine, out_e)
    return out.reshape(B, S, D)
