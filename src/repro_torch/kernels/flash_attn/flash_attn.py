"""Causal flash-attention forward: the wrapper around the CUDA kernel
``csrc/flash_attn.cu`` (blocked online softmax, optional sliding window;
the S x S scores never reach device memory).

Dispatch is by the device of the tensors: CPU tensors take the plain
PyTorch version (``ref.py``); CUDA tensors launch the kernel or raise.  The
kernel takes float32 or bf16 and a head dim of 32, 64, 96 or 128 (every
head dim the repo's configurations have), and any S; ``bq`` and ``bk`` are
the reference's block sizes and keep its contract (S a multiple of both).
bf16 runs on the tensor cores (``mma.sync``, 64 queries by 64 keys a tile),
float32 on the CUDA cores in true float32 (64 queries by 32 keys);
``ref.attention_limit`` states how far each may be from the plain version.

The dispatch is the operator ``torch.ops.repro_torch.flash_attention``, so
tools that trace the port see one call with the kernel's cost: on fake
tensors (``FakeTensorMode``) it only shapes its output, and its FLOP
formula for ``torch.utils.flop_counter`` is the kernel's work, 4 D per
unmasked (query, key) pair and head, not the plain version's S x S scores.
"""

from __future__ import annotations

import math
from ctypes import c_float, c_int, c_void_p
from typing import Dict, Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from .ref import attention_pairs, attention_ref

DEFAULT_BQ = 128
DEFAULT_BK = 128
HEAD_DIMS = (32, 64, 96, 128)  # head dims the CUDA kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches, bumped where the kernel is launched and nowhere else
LAUNCHES: Dict[str, int] = {"flash_attention": 0}

# flash_attention_launch's C signature (csrc/flash_attn.cu)
_ARGS = (c_void_p, c_void_p, c_void_p, c_void_p,  # q, k, v, o
         c_int, c_int, c_int,                     # bh, s, d
         c_int, c_float, c_int,                   # window (0: none), scale, bf16
         c_void_p)                                # stream


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def flash_attention(
    q: torch.Tensor,  # [BH, S, D]  (batch*heads flattened)
    k: torch.Tensor,  # [BH, S, D]
    v: torch.Tensor,  # [BH, S, D]
    window: Optional[int] = None,
    bq: int = DEFAULT_BQ,
    bk: int = DEFAULT_BK,
) -> torch.Tensor:  # [BH, S, D] in q's dtype
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k, v must share one [BH, S, D] shape")
    BH, S, D = q.shape
    if S % bq or S % bk:
        raise ValueError(f"pad S={S} to block multiples")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return torch.ops.repro_torch.flash_attention(q, k, v, window)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _dispatch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: Optional[int]) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_ref(q, k, v, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch_cuda(q, k, v, window)


@_dispatch.register_fake
def _(q, k, v, window):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flops(q_shape, k_shape, v_shape, window=None, *args, out_shape=None,
           **kwargs) -> int:
    BH, S, D = q_shape
    return 4 * D * BH * attention_pairs(S, window)


def _launch_cuda(q, k, v, window) -> torch.Tensor:
    from .._build import launcher

    dev = q.device
    BH, S, D = q.shape
    if q.dtype not in _DTYPES or D not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes float32 or bfloat16 and a head "
                         f"dim in {HEAD_DIMS}, got {q.dtype} and {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {q.dtype} tensor "
                             f"on {dev}")
    out = torch.empty_like(q)
    launch = launcher("flash_attention_launch", *_ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, S, D,
            window or 0, 1.0 / math.sqrt(D), _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {rc}")
    LAUNCHES["flash_attention"] += 1
    return out
