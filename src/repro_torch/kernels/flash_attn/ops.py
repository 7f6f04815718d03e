"""Entry point of flash attention: model layout ``[B, S, H, D]`` onto the
kernel's ``[BH, S, D]``."""

from __future__ import annotations

from typing import Optional

from .flash_attn import flash_attention
from .ref import attention_ref


def _fold(x):
    """[B, S, H, D] -> a contiguous [B*H, S, D] copy (at B = 1 ``reshape``
    alone returns a strided view, which the kernel does not take)."""
    B, S, H, D = x.shape
    return x.movedim(2, 1).reshape(B * H, S, D).contiguous()


def _unfold(x, B: int, H: int):
    BH, S, D = x.shape
    return x.reshape(B, H, S, D).movedim(1, 2)


def mha_flash(q, k, v, window: Optional[int] = None):
    """q,k,v: [B, S, H, D] (H already GQA-expanded) -> [B, S, H, D]."""
    B, S, H, D = q.shape
    out = flash_attention(_fold(q), _fold(k), _fold(v), window=window)
    return _unfold(out, B, H)


def mha_ref(q, k, v, window: Optional[int] = None):
    B, S, H, D = q.shape
    return _unfold(attention_ref(_fold(q), _fold(k), _fold(v), window=window),
                   B, H)
