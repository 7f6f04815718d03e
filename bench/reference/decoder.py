"""Plain reference of a pre-norm decoder (Qwen2, Phi-3 and their kin), in
float32 with TF32 off: what the benchmark holds the port's outputs to.

It is written from the published architecture and the weight layout of
``benchlib.weights`` alone; it imports nothing of the port.  A block is

    h = x + Wo(attn(rope(Wq n1(x) + bq), rope(Wk n1(x) + bk), Wv n1(x) + bv))
    y = h + Wd(silu(Wg n2(h)) * Wu n2(h))

with RMSNorm ``x / sqrt(mean(x^2) + eps) * w``, grouped-query attention
(query head j reads KV head j // (H / Hkv)), causal softmax scaled by
1 / sqrt(hd), and the final RMSNorm and head giving the logits.  RoPE
rotates interleaved pairs ``(x[2i], x[2i+1])`` by ``pos / theta^(2i/hd)``:
Hugging Face's ``rotate_half`` pairs ``(x[i], x[i + hd/2])`` instead, which
is the same map after a fixed permutation of each head's columns of Wq, Wk
(and bq, bk); the weights here are random, so the two are one model.  A
vision configuration (``n_patches`` > 0) takes its stubbed tower's patch
embeddings as the first positions, and its loss covers the text positions.

Attention runs over blocks of queries and only the keys they can see;
training runs each block under ``torch.utils.checkpoint`` and the head
with its cross entropy over blocks of rows, so a full-size step fits.

``precision="fp8"`` is the control: every linear layer's operands rounded
to float8 e4m3 with one scale per tensor (amax to 448), the products in
float32, as an fp8 training path would run them.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Q_BLOCK = 512
ROW_BLOCK = 1024
FP8_MAX = 448.0


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matrix products and convolutions while open."""
    mm, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(prec)


def _sizes(conf: dict):
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    return d, H, conf["num_key_value_heads"], conf.get("head_dim") or d // H


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under one per-tensor scale; the gradient passes
    straight through."""
    xd = x.detach()
    scale = FP8_MAX / xd.abs().amax().clamp(min=1e-30)
    q = (xd * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - xd)


def linear(x, w, precision: str):
    if precision == "fp8":
        return fp8(x) @ fp8(w)
    return x @ w


def rmsnorm(x, w, eps: float):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def rope(x, theta: float):
    """x: [B, S, H, hd], positions 0..S-1, interleaved pairs."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    c, s = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).flatten(-2)


def attention(q, k, v):
    """Causal attention of q [B, S, H, hd] over k, v [B, S, H, hd] by
    blocks of queries, each over the keys up to its last query."""
    S, hd = q.shape[1], q.shape[-1]
    outs = []
    for a in range(0, S, Q_BLOCK):
        b = min(a + Q_BLOCK, S)
        sc = torch.einsum("bqhd,bkhd->bhqk", q[:, a:b], k[:, :b]) / math.sqrt(hd)
        qpos = torch.arange(a, b, device=q.device)[:, None]
        kpos = torch.arange(b, device=q.device)[None, :]
        sc = sc.masked_fill(kpos > qpos, float("-inf"))
        outs.append(torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, dim=-1), v[:, :b]))
    return torch.cat(outs, dim=1)


def block(x, W: Dict[str, torch.Tensor], i: int, conf: dict, precision: str):
    d, H, kv, hd = _sizes(conf)
    p, eps = f"layers.{i}.", conf["rms_norm_eps"]
    B, S, _ = x.shape
    n = rmsnorm(x, W[p + "norm1"], eps)
    q = linear(n, W[p + "attn.wq"].reshape(d, H * hd), precision).view(B, S, H, hd)
    k = linear(n, W[p + "attn.wk"].reshape(d, kv * hd), precision).view(B, S, kv, hd)
    v = linear(n, W[p + "attn.wv"].reshape(d, kv * hd), precision).view(B, S, kv, hd)
    if conf.get("qkv_bias"):
        q, k, v = q + W[p + "attn.bq"], k + W[p + "attn.bk"], v + W[p + "attn.bv"]
    q, k = rope(q, conf["rope_theta"]), rope(k, conf["rope_theta"])
    k, v = (t.repeat_interleave(H // kv, dim=2) for t in (k, v))
    o = attention(q, k, v).reshape(B, S, H * hd)
    h = x + linear(o, W[p + "attn.wo"].reshape(H * hd, d), precision)
    n2 = rmsnorm(h, W[p + "norm2"], eps)
    g = F.silu(linear(n2, W[p + "ffn.w_gate"], precision))
    u = linear(n2, W[p + "ffn.w_up"], precision)
    return h + linear(g * u, W[p + "ffn.w_down"], precision)


def embed(W, conf: dict, tokens, patches=None):
    x = W["embed"][tokens.long()]
    if conf.get("n_patches"):
        x = torch.cat([patches.to(torch.float32), x], dim=1)
    return x


def hidden(W, conf: dict, tokens, patches=None, precision: str = "float32",
           remat: bool = False):
    """The final-normed hidden sequence [B, S, d]."""
    x = embed(W, conf, tokens, patches)
    for i in range(conf["num_hidden_layers"]):
        if remat:
            x = checkpoint(block, x, W, i, conf, precision, use_reentrant=False)
        else:
            x = block(x, W, i, conf, precision)
    return rmsnorm(x, W["final_norm"], conf["rms_norm_eps"])


def logits(W, h, precision: str = "float32"):
    return linear(h, W["lm_head"], precision)


def _nll_sum(h, labels, head, precision: str):
    lg = linear(h, head, precision)
    return (torch.logsumexp(lg, dim=-1)
            - lg.gather(-1, labels[:, None].long())[:, 0]).sum()


def loss(W, conf: dict, tokens, labels, patches=None, precision: str = "float32"):
    """Mean next-token cross entropy over the text positions, each block
    and each block of head rows recomputed in the backward."""
    h = hidden(W, conf, tokens, patches, precision, remat=True)
    P = conf.get("n_patches") or 0
    h = h[:, P:-1].reshape(-1, h.shape[-1])
    lab = labels[:, 1:].reshape(-1)
    total = 0.0
    for a in range(0, h.shape[0], ROW_BLOCK):
        total = total + checkpoint(_nll_sum, h[a:a + ROW_BLOCK], lab[a:a + ROW_BLOCK],
                                   W["lm_head"], precision, use_reentrant=False)
    return total / lab.numel()


def loss_and_grads(W, conf: dict, batch: dict, microbatches: int,
                   precision: str = "float32"):
    """(mean loss, float32 gradients summed over the microbatches and
    divided by their count), as a step with gradient accumulation takes
    them."""
    names = list(W)
    B = batch["tokens"].shape[0]
    grads: Optional[list] = None
    total = 0.0
    for a in range(microbatches):
        sl = slice(a * B // microbatches, (a + 1) * B // microbatches)
        mb_loss = loss(W, conf, batch["tokens"][sl], batch["labels"][sl],
                       batch["patches"][sl] if "patches" in batch else None, precision)
        g = torch.autograd.grad(mb_loss, [W[n] for n in names])
        grads = list(g) if grads is None else [x + y for x, y in zip(grads, g)]
        total += float(mb_loss.detach())
    return total / microbatches, {n: g / microbatches for n, g in zip(names, grads)}


@torch.no_grad()
def last_logits(W, conf: dict, tokens, patches=None, precision: str = "float32"):
    """Logits [B, V] at the last position of each prompt."""
    return logits(W, hidden(W, conf, tokens, patches, precision)[:, -1], precision)
