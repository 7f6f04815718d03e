"""Plain PyTorch versions of causal (optionally sliding-window) attention
and of its gradients; they materialise the S x S scores.  The wrappers in
``flash_attn.py`` run them for CPU tensors.

* :func:`attention_ref`: a step-for-step copy of the reference's oracle:
  float32 scores scaled by 1/sqrt(D), masked to -1e30, softmax in float32.
* :func:`attention_lse_ref`: the log-sum-exp of those scores that the
  forward kernel writes for the backward.
* :func:`attention_bwd_ref`: dq, dk, dv from the forward's output and
  log-sum-exp, in the backward kernel's arithmetic.

:func:`attention_limit` states how far the forward kernel may be from
:func:`attention_ref`, per element, and :data:`BF16_RMS_LIMIT` over all
elements of a bf16 call; :func:`attention_bwd_limit` and
:data:`BWD_BF16_RMS_LIMIT` do the same for the backward kernel against
:func:`attention_bwd_ref`."""

from __future__ import annotations

import math
from typing import Optional

import torch


# RMS(kernel - want) / RMS(want) that a bf16 call is held to.  The CPU
# emulation of the kernel's rounding (P to bf16 before P V, then the output)
# reads at most 2.2e-3 up to S = 4,096; the control that also rounds the
# scores to bf16 (:func:`attention_bf16_scores`) reads at least 3.0e-3.
BF16_RMS_LIMIT = 2.5e-3

# RMS(kernel - want) / RMS(want) of each of dq, dk and dv that a bf16
# backward call is held to, ``want`` = :func:`attention_bwd_ref`.  The CPU
# emulation of the kernel's rounding (:func:`attention_bwd_bf16`: P and dS
# to bf16 before their products, then the outputs) reads at most 2.96e-3
# at head dims 32-128, S = 64-4,096 and windows none, 40 and 100 (2.63e-3
# to 2.69e-3 at S = 4,096); the control that also rounds the scaled scores
# to bf16 (:func:`attention_bwd_bf16_scores`) reads at least 3.32e-3
# (4.13e-3 at S = 4,096): ``scripts/k5_bwd_bf16_limit.py``.
BWD_BF16_RMS_LIMIT = 3.1e-3


def _keep(S: int, window: Optional[int], device) -> torch.Tensor:
    """``[S, S]`` mask of the (query, key) pairs attention sees."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(S, device=device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _scores(q, k, window: Optional[int] = None):
    """The float32 scaled scores, masked to -1e30: ``[BH, S, S]``."""
    BH, S, D = q.shape
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (1.0 / math.sqrt(D))
    return s.masked_fill(~_keep(S, window, q.device)[None], -1e30)


def _probs(q, k, window: Optional[int] = None, score_dtype=torch.float32):
    """The float32 softmax of the masked, scaled scores: ``[BH, S, S]``;
    the scaled scores are rounded to ``score_dtype`` first."""
    BH, S, D = q.shape
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    s = s.to(score_dtype).float()
    s = s.masked_fill(~_keep(S, window, q.device)[None], -1e30)
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


# --------------------------------------------------------------------------- #
# the backward
# --------------------------------------------------------------------------- #


def attention_lse_ref(q, k, v, window: Optional[int] = None):
    """``[BH, S]`` float32 log-sum-exp (natural log) of each query's
    scaled, masked scores: what the forward kernel writes beside o, so that
    the backward recomputes P = exp(s * scale - lse) without a max or a
    sum.  ``v`` is not read; it keeps the kernel's signature."""
    return torch.logsumexp(_scores(q, k, window), dim=-1)


def _p_from_lse(q, k, lse, window, f, round_scores=False):
    """P = exp(s * scale - lse) in dtype ``f``, masked entries set to 0
    (never computed as exp(-1e30 - lse)); the scaled scores rounded to bf16
    first with ``round_scores``."""
    S, D = q.shape[1:]
    s = torch.einsum("bqd,bkd->bqk", q.to(f), k.to(f)) * (1.0 / math.sqrt(D))
    if round_scores:
        s = s.to(torch.bfloat16).to(f)
    return torch.where(_keep(S, window, q.device)[None],
                       torch.exp(s - lse.to(f)[..., None]), 0.0)


def _bwd(q, k, v, o, lse, do, window, rounded=()):
    """dq, dk, dv in float32 (float64 for float64 inputs), step by step as
    the backward kernel computes them; ``rounded`` names the intermediates
    rounded to bf16 before what reads them: the scaled scores "s", "p",
    "dp", "ds"."""
    scale = 1.0 / math.sqrt(q.shape[-1])

    def r(name, x):
        return x.to(torch.bfloat16).to(x.dtype) if name in rounded else x

    f = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf, kf, vf, dof = (t.to(f) for t in (q, k, v, do))
    delta = (dof * o.to(f)).sum(-1)
    p = _p_from_lse(q, k, lse, window, f, round_scores="s" in rounded)
    dv = torch.einsum("bqk,bqd->bkd", r("p", p), dof)
    dp = r("dp", torch.einsum("bqd,bkd->bqk", dof, vf))
    ds = r("ds", p * (dp - delta[..., None]))
    del p, dp
    dq = torch.einsum("bqk,bkd->bqd", ds, kf) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, qf) * scale
    return dq, dk, dv


def attention_bwd_ref(q, k, v, o, lse, do, window: Optional[int] = None):
    """Gradients of :func:`attention_ref` from its output ``o`` (float32,
    as the forward kernel hands it to the backward), its log-sum-exp
    ``lse`` (``[BH, S]`` float32, :func:`attention_lse_ref`) and the
    output's gradient ``do``: ``(dq, dk, dv)`` in q's dtype,
    computed in float32 as the kernel does: delta = rowsum(do * o), P =
    exp(s * scale - lse) with masked entries 0, dV = P^T dO, dP = dO V^T,
    dS = P * (dP - delta), dQ = dS K * scale, dK = dS^T Q * scale."""
    return tuple(t.to(q.dtype) for t in _bwd(q, k, v, o, lse, do, window))


def attention_bwd_bf16(q, k, v, o, lse, do, window: Optional[int] = None):
    """The bf16 backward kernel's roundings on the CPU: P rounded to bf16
    before dV = P^T dO and dS before dQ and dK, as the tensor cores take
    them; the outputs rounded to q's dtype."""
    return tuple(t.to(q.dtype) for t in
                 _bwd(q, k, v, o, lse, do, window, rounded=("p", "ds")))


def attention_bwd_bf16_scores(q, k, v, o, lse, do, window: Optional[int] = None):
    """A control of lower precision than the kernel: :func:`attention_bwd_bf16`
    with the scaled scores also rounded to bf16 before P = exp(s - lse),
    which :data:`BWD_BF16_RMS_LIMIT` must refuse."""
    return tuple(t.to(q.dtype) for t in
                 _bwd(q, k, v, o, lse, do, window, rounded=("s", "p", "ds")))


def attention_bwd_limit(q, k, v, o, lse, do, window: Optional[int] = None):
    """Per-element limits on ``|kernel - want|`` of a float32 backward call,
    ``want`` = :func:`attention_bwd_ref` of the same inputs: float32
    ``(dq, dk, dv)`` of ``2e-5 * spread + 1e-6``.

    The kernel computes in true float32 and differs from the plain version
    only in the order of its sums (and ``expf``'s last bit), so each
    element may differ by a small share of the sum of the absolute values
    of the terms it adds up, its spread: dV's is P^T |dO|; dK's and dQ's
    scale * A^T |Q| and scale * A |K|, where A = P (|dO| |V|^T +
    rowsum(|dO| |O|)) bounds |dS| and the size of its rounding.  A float32
    sum in any order is within about 1e-7 of its spread; 2e-5 leaves room
    for expf and the exponent's rounding."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qa, ka, va, doa = (t.float().abs() for t in (q, k, v, do))
    p = _p_from_lse(q, k, lse, window, torch.float32)
    spread_dv = torch.einsum("bqk,bqd->bkd", p, doa)
    a = p * (torch.einsum("bqd,bkd->bqk", doa, va)
             + (doa * o.float().abs()).sum(-1)[..., None])
    del p
    spread_dq = torch.einsum("bqk,bkd->bqd", a, ka) * scale
    spread_dk = torch.einsum("bqk,bqd->bkd", a, qa) * scale
    return tuple(2e-5 * x + 1e-6 for x in (spread_dq, spread_dk, spread_dv))
