"""Causal flash attention, forward and backward: the wrappers around the
CUDA kernels ``csrc/flash_attn.cu`` (blocked online softmax, optional
sliding window; the S x S scores never reach device memory) and
``csrc/flash_attn_bwd.cu`` (dq, dk and dv from the forward's output and
log-sum-exp, recomputing P tile by tile).

Dispatch is by the device of the tensors: CPU tensors take the plain
PyTorch versions (``ref.py``); CUDA tensors launch the kernel or raise.  The
kernels take float32 or bf16 and a head dim of 32, 64, 96 or 128 (every
head dim the repo's configurations have), and any S; ``bq`` and ``bk`` are
the reference's block sizes and keep its contract (S a multiple of both).
bf16 runs on the tensor cores (``mma.sync``), float32 on the CUDA cores in
true float32; ``ref.attention_limit`` and ``ref.attention_bwd_limit``
state how far each may be from the plain version.

Each dispatch is an operator, so tools that trace the port see one call
with the kernel's cost: on fake tensors (``FakeTensorMode``) it only shapes
its outputs, and its FLOP formula for ``torch.utils.flop_counter`` is the
kernel's work, not the plain version's S x S scores:

* ``torch.ops.repro_torch.flash_attention``: o, for prefill (4 D per
  unmasked (query, key) pair and head);
* ``torch.ops.repro_torch.flash_attention_fwd``: (o, lse), the forward
  under autograd (the same kernel, the same 4 D): o in float32 whatever
  the inputs' type, and the ``[BH, S]`` float32 log-sum-exp, both read by
  the backward;
* ``torch.ops.repro_torch.flash_attention_backward``: (dq, dk, dv), 10 D
  per pair and head (five products).
"""

from __future__ import annotations

import math
from ctypes import c_float, c_int, c_void_p
from typing import Dict, Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from .ref import attention_bwd_ref, attention_lse_ref, attention_pairs, attention_ref

DEFAULT_BQ = 128
DEFAULT_BK = 128
HEAD_DIMS = (32, 64, 96, 128)  # head dims the CUDA kernels are built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches, bumped where a kernel is launched and nowhere else; the
# forward with or without its log-sum-exp is one kernel
LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_backward": 0}

# flash_attention_launch's C signature (csrc/flash_attn.cu)
_ARGS = (c_void_p, c_void_p, c_void_p, c_void_p,  # q, k, v, o
         c_void_p,                                # lse (null: not written)
         c_int, c_int, c_int,                     # bh, s, d
         c_int, c_float, c_int,                   # window (0: none), scale, bf16
         c_int, c_void_p)                         # o in float32, stream
# flash_attention_bwd_launch's (csrc/flash_attn_bwd.cu)
_BWD_ARGS = (c_void_p, c_void_p, c_void_p, c_void_p,  # q, k, v, o
             c_void_p, c_void_p,                      # do, lse
             c_void_p, c_void_p, c_void_p,            # dq, dk, dv
             c_void_p,                                # delta scratch
             c_int, c_int, c_int,                     # bh, s, d
             c_int, c_float, c_int,                   # window, scale, bf16
             c_void_p)                                # stream


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(q, k, v, window, bq: int, bk: int) -> None:
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k, v must share one [BH, S, D] shape")
    S = q.shape[1]
    if S % bq or S % bk:
        raise ValueError(f"pad S={S} to block multiples")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def flash_attention(
    q: torch.Tensor,  # [BH, S, D]  (batch*heads flattened)
    k: torch.Tensor,  # [BH, S, D]
    v: torch.Tensor,  # [BH, S, D]
    window: Optional[int] = None,
    bq: int = DEFAULT_BQ,
    bk: int = DEFAULT_BK,
) -> torch.Tensor:  # [BH, S, D] in q's dtype
    _check(q, k, v, window, bq, bk)
    return torch.ops.repro_torch.flash_attention(q, k, v, window)


def flash_attention_fwd(q, k, v, window: Optional[int] = None,
                        bq: int = DEFAULT_BQ, bk: int = DEFAULT_BK):
    """:func:`flash_attention` in float32 (not rounded to q's dtype) and its
    ``[BH, S]`` float32 log-sum-exp (natural log of each query's scaled,
    masked scores): ``(o, lse)``, what :func:`flash_attention_backward`
    reads."""
    _check(q, k, v, window, bq, bk)
    return torch.ops.repro_torch.flash_attention_fwd(q, k, v, window)


def flash_attention_backward(q, k, v, o, lse, do, window: Optional[int] = None):
    """Gradients of :func:`flash_attention` with respect to q, k and v,
    from :func:`flash_attention_fwd`'s float32 ``o`` and ``lse`` and the
    output's gradient ``do`` (q's dtype and shape): ``(dq, dk, dv)`` in q's
    dtype."""
    _check(q, k, v, window, 1, 1)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:2]:
        raise ValueError("o and do must be [BH, S, D] and lse [BH, S]")
    return torch.ops.repro_torch.flash_attention_backward(q, k, v, o, lse, do,
                                                          window)


# --------------------------------------------------------------------------- #
# the operators
# --------------------------------------------------------------------------- #


def _device(q, name: str) -> bool:
    """True for CPU tensors (the plain version), False for CUDA ones."""
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    return False


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _dispatch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: Optional[int]) -> torch.Tensor:
    if _device(q, "flash_attention"):
        return attention_ref(q, k, v, window=window)
    return _launch_cuda(q, k, v, window, with_lse=False)[0]


@_dispatch.register_fake
def _(q, k, v, window):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def _dispatch_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: Optional[int]) -> tuple[torch.Tensor, torch.Tensor]:
    if _device(q, "flash_attention_fwd"):
        return (attention_ref(q.float(), k.float(), v.float(), window=window),
                attention_lse_ref(q, k, v, window=window))
    return _launch_cuda(q, k, v, window, with_lse=True)


@_dispatch_fwd.register_fake
def _(q, k, v, window):
    return (torch.empty_like(q, dtype=torch.float32),
            q.new_empty(q.shape[:2], dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_attention_backward", mutates_args=())
def _dispatch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  window: Optional[int]
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if _device(q, "flash_attention_backward"):
        return attention_bwd_ref(q, k, v, o, lse, do, window=window)
    return _launch_bwd_cuda(q, k, v, o, lse, do, window)


@_dispatch_bwd.register_fake
def _(q, k, v, o, lse, do, window):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flops(q_shape, k_shape, v_shape, window=None, *args, out_shape=None,
           **kwargs) -> int:
    BH, S, D = q_shape
    return 4 * D * BH * attention_pairs(S, window)


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _flops_fwd(q_shape, k_shape, v_shape, window=None, *args, out_shape=None,
               **kwargs) -> int:
    BH, S, D = q_shape
    return 4 * D * BH * attention_pairs(S, window)


@register_flop_formula(torch.ops.repro_torch.flash_attention_backward)
def _flops_bwd(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape,
               window=None, *args, out_shape=None, **kwargs) -> int:
    """Five products of 2 D flops per unmasked pair and head: S = Q K^T,
    dP = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q."""
    BH, S, D = q_shape
    return 10 * D * BH * attention_pairs(S, window)


# --------------------------------------------------------------------------- #
# the CUDA launches
# --------------------------------------------------------------------------- #


def _cuda_operands(named, dtype, dev) -> None:
    for name, t in named:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor "
                             f"on {dev}")


def _head_dim(q, name: str) -> None:
    D = q.shape[-1]
    if q.dtype not in _DTYPES or D not in HEAD_DIMS:
        raise ValueError(f"the CUDA {name} kernel takes float32 or bfloat16 "
                         f"and a head dim in {HEAD_DIMS}, got {q.dtype} and {D}")


def _launch_cuda(q, k, v, window, with_lse: bool):
    from .._build import launcher

    dev = q.device
    BH, S, D = q.shape
    _head_dim(q, "flash_attention")
    _cuda_operands((("q", q), ("k", k), ("v", v)), q.dtype, dev)
    # under autograd o is float32 for the backward's delta
    out = torch.empty_like(q, dtype=torch.float32 if with_lse else q.dtype)
    lse = torch.empty((BH, S), dtype=torch.float32, device=dev) if with_lse else None
    launch = launcher("flash_attention_launch", *_ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, BH, S, D,
            window or 0, 1.0 / math.sqrt(D), _DTYPES[q.dtype], int(with_lse),
            stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {rc}")
    LAUNCHES["flash_attention"] += 1
    return out, lse


def _launch_bwd_cuda(q, k, v, o, lse, do, window):
    from .._build import launcher

    dev = q.device
    BH, S, D = q.shape
    _head_dim(q, "flash_attention_backward")
    _cuda_operands((("q", q), ("k", k), ("v", v), ("do", do)), q.dtype, dev)
    _cuda_operands((("o", o), ("lse", lse)), torch.float32, dev)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((BH, S), dtype=torch.float32, device=dev)
    launch = launcher("flash_attention_bwd_launch", *_BWD_ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), BH, S, D, window or 0,
            1.0 / math.sqrt(D), _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_backward kernel launch failed: "
                           f"cudaError {rc}")
    LAUNCHES["flash_attention_backward"] += 1
    return dq, dk, dv
