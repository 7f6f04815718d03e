"""Plain PyTorch version of causal (optionally sliding-window) attention, a
step-for-step copy of the reference's oracle: float32 scores scaled by
1/sqrt(D), masked to -1e30, softmax in float32.  It materialises the S x S
scores.  The wrapper in ``flash_attn.py`` runs it for CPU tensors.

:func:`attention_limit` states how far the CUDA kernel may be from it, per
element; :data:`BF16_RMS_LIMIT` over all elements of a bf16 call."""

from __future__ import annotations

import math
from typing import Optional

import torch


# RMS(kernel - want) / RMS(want) that a bf16 call is held to.  The CPU
# emulation of the kernel's rounding (P to bf16 before P V, then the output)
# reads at most 2.2e-3 up to S = 4,096; the control that also rounds the
# scores to bf16 (:func:`attention_bf16_scores`) reads at least 3.0e-3.
BF16_RMS_LIMIT = 2.5e-3


def _probs(q, k, window: Optional[int] = None, score_dtype=torch.float32):
    """The float32 softmax of the masked, scaled scores: ``[BH, S, S]``;
    the scaled scores are rounded to ``score_dtype`` first."""
    BH, S, D = q.shape
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    s = s.to(score_dtype).float()
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask[None], -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return p / p.sum(dim=-1, keepdim=True)


def attention_pairs(s: int, window: Optional[int] = None) -> int:
    """Unmasked (query, key) pairs of causal attention over ``s``
    positions, keys more than ``window - 1`` behind the query masked: the
    pairs whose scores and P V products a kernel must compute."""
    w = s if window is None else min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def attention_ref(q, k, v, window: Optional[int] = None):
    """q,k,v: [BH, S, D] -> [BH, S, D] in q's dtype."""
    p = _probs(q, k, window)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def attention_limit(q, k, v, want, window: Optional[int] = None):
    """Per-element limit on ``|kernel - want|``, ``want`` =
    :func:`attention_ref` of the same inputs; float32 ``[BH, S, D]``.

    float32: ``2e-5 + 2e-5 * |want|``; the kernel computes in true float32.
    bf16: ``2**-7 * |want| + 2**-8 * (A @ |V|) + 1e-3``, A the exact
    softmax.  Both sides round the output to bf16 once (one ulp, at most
    2**-7 of the value); the kernel also rounds P to bf16 before P V, as
    every tensor-core attention does, which moves each p_i by at most
    2**-8 * p_i and so an output by at most 2**-8 * (A @ |V|)."""
    size = want.float().abs()
    if q.dtype != torch.bfloat16:
        return 2e-5 + 2e-5 * size
    spread = torch.einsum("bqk,bkd->bqd", _probs(q, k, window), v.float().abs())
    return 2 ** -7 * size + 2 ** -8 * spread + 1e-3


def rms_ratio(got, want) -> float:
    """``RMS(got - want) / RMS(want)`` over all elements, in float32."""
    err = got.float() - want.float()
    return float(err.square().mean().sqrt() / want.float().square().mean().sqrt())


def attention_bf16_scores(q, k, v, window: Optional[int] = None):
    """A control of lower precision than the kernel: :func:`attention_ref`
    with the scaled scores and the probabilities rounded to bf16, which
    :data:`BF16_RMS_LIMIT` must refuse."""
    p = _probs(q, k, window, torch.bfloat16).to(torch.bfloat16).float()
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
