"""Entry point of flash attention: model layout ``[B, S, H, D]`` onto the
kernel's ``[BH, S, D]``, differentiable.

K5 is a forward kernel, as the reference's Pallas kernel is (it has no
``custom_vjp``).  :class:`FlashAttention` makes it an autograd node: the
forward is :func:`flash_attention` (the kernel on a CUDA tensor, the plain
version on the CPU), and the backward recomputes the plain version
(``ref.attention_ref``) from the saved q, k, v and returns its gradients.
That backward materialises ``[BH, S, S]`` float32 scores, a few at once.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attn import flash_attention
from .ref import attention_ref


class FlashAttention(torch.autograd.Function):
    """``flash_attention(q, k, v, window)`` of ``[BH, S, D]`` tensors with
    the plain version's gradients."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        ctx.window = window
        ctx.save_for_backward(q, k, v)
        return flash_attention(q, k, v, window=window)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = attention_ref(*leaves, window=ctx.window)
            dq, dk, dv = torch.autograd.grad(out, leaves, grad)
        return dq, dk, dv, None


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
    out = FlashAttention.apply(_fold(q), _fold(k), _fold(v), window)
    return _unfold(out, B, H)


def mha_ref(q, k, v, window: Optional[int] = None):
    B, S, H, D = q.shape
    return _unfold(attention_ref(_fold(q), _fold(k), _fold(v), window=window),
                   B, H)
