"""Entry point of flash attention: model layout ``[B, S, H, D]`` onto the
kernels' ``[BH, S, D]``, differentiable.

The reference's Pallas kernel is a forward kernel only (it has no
``custom_vjp``; JAX differentiates the plain attention).
:class:`FlashAttention` makes K5 an autograd node whose backward is a
kernel too.  Where a gradient is wanted, the forward is
:func:`flash_attention_fwd` (the kernel, which also writes the
log-sum-exp and o in float32, which the node rounds to q's dtype and keeps
for the backward) and the backward :func:`flash_attention_backward` (the
backward kernel, recomputing P tile by tile from q, k, v and the
log-sum-exp): no ``[BH, S, S]`` tensor reaches the card.  Without one
(prefill), the forward is :func:`flash_attention` alone.  On CPU tensors
the forward is the plain version and the backward is autograd through it
(``ref.attention_ref``), the plain version's own gradients; fake tensors
(``FakeTensorMode``) take the operators, as the card does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch._subclasses.fake_tensor import is_fake

from .flash_attn import (flash_attention, flash_attention_backward,
                         flash_attention_fwd)
from .ref import attention_ref


def _plain(t: torch.Tensor) -> bool:
    """A real CPU tensor: the plain version's route."""
    return t.device.type == "cpu" and not is_fake(t)


class FlashAttention(torch.autograd.Function):
    """``flash_attention(q, k, v, window)`` of ``[BH, S, D]`` tensors,
    differentiable through the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        ctx.window = window
        ctx.plain = _plain(q)
        if ctx.plain or not any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, k, v)
            return flash_attention(q, k, v, window=window)
        o, lse = flash_attention_fwd(q, k, v, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, grad):
        if ctx.plain:
            q, k, v = ctx.saved_tensors
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                out = attention_ref(*leaves, window=ctx.window)
                dq, dk, dv = torch.autograd.grad(out, leaves, grad)
            return dq, dk, dv, None
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, o, lse, grad.to(q.dtype).contiguous(), window=ctx.window)
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
