"""Plain PyTorch version of causal (optionally sliding-window) attention, a
step-for-step copy of the reference's oracle: float32 scores scaled by
1/sqrt(D), masked to -1e30, softmax in float32.  It materialises the S x S
scores.  The wrapper in ``flash_attn.py`` runs it for CPU tensors."""

from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(q, k, v, window: Optional[int] = None):
    """q,k,v: [BH, S, D] -> [BH, S, D] in q's dtype."""
    BH, S, D = q.shape
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask[None], -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
