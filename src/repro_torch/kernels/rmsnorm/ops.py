"""RMSNorm, differentiable: the wrapper around the CUDA kernels
``csrc/rmsnorm.cu`` (a forward that also writes each row's float32
``rstd``, and a backward of dx and of dw's per-CTA partials, summed by a
second kernel in a fixed order).

Dispatch is by the tensors, in :func:`rmsnorm` alone: real CPU tensors
take the plain version (``ref.rmsnorm_ref``, the eager op, and autograd
through it); fake tensors (``FakeTensorMode``) take the operators, which
only shape their outputs; CUDA tensors launch the kernels or raise.  The
kernels take activations in float32 or bf16, any row count and a last dim
``d`` of 1 to :data:`D_MAX`; the weight is read in float32 and its
gradient is formed in float32.  The operators, which tools that trace the port see (on CUDA
tensors they launch the same kernels):

* ``torch.ops.repro_torch.rmsnorm_fwd(x, w, eps)``: ``(y, rstd)``, y in
  x's type and rstd ``x.shape[:-1]`` float32;
* ``torch.ops.repro_torch.rmsnorm_bwd(x, w, rstd, g)``: ``(dx, dw)``, dx
  in x's type and dw ``[d]`` float32.
"""

from __future__ import annotations

from ctypes import c_float, c_int, c_void_p
from typing import Dict

import torch
from torch._subclasses.fake_tensor import is_fake

from .ref import rmsnorm_ref

D_MAX = 7168  # the widest row: the backward's per-warp sums fill 227 KB
# the backward's fixed split of the rows: each CTA's run of rows, whose sum
# of dy t is one partial row of dw
BWD_ROWS = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches, bumped where a kernel is launched and nowhere else; a
# backward is the backward kernel and the kernel that sums its partials
LAUNCHES: Dict[str, int] = {"rmsnorm_fwd": 0, "rmsnorm_bwd": 0}

# rmsnorm_fwd_launch's C signature (csrc/rmsnorm.cu)
_FWD_ARGS = (c_void_p, c_void_p, c_void_p, c_void_p,  # x, w, y, rstd
             c_int, c_int, c_float, c_int, c_void_p)  # n, d, eps, bf16, stream
# rmsnorm_bwd_launch's
_BWD_ARGS = (c_void_p, c_void_p, c_void_p, c_void_p,  # x, w, rstd, g
             c_void_p, c_void_p, c_void_p,            # dx, partials, dw
             c_int, c_int, c_int, c_int, c_void_p)    # n, d, rows, bf16, stream


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class RMSNorm(torch.autograd.Function):
    """``rmsnorm_fwd``'s y, differentiable through ``rmsnorm_bwd``.  Real
    tensors launch the kernels directly: through the operators a forward
    and a backward cost an H100's host 183 us against 100 (``chip_smoke.py``'s
    ``rmsnorm_host`` line), at some 300 calls a training step; fake tensors
    take the operators."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.real = not is_fake(x)
        fwd = _launch_fwd if ctx.real else torch.ops.repro_torch.rmsnorm_fwd
        y, rstd = fwd(x, w, eps)
        ctx.save_for_backward(x, w, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, rstd = ctx.saved_tensors
        bwd = _launch_bwd if ctx.real else torch.ops.repro_torch.rmsnorm_bwd
        dx, dw = bwd(x, w, rstd, g.to(x.dtype).contiguous())
        return dx, dw.to(w.dtype), None


def rmsnorm(x, w, eps: float):
    """RMSNorm of ``x [..., d]`` with weight ``w [d]``: the plain version on
    real CPU tensors, the kernels (or, on fake tensors, their operators)
    otherwise."""
    if x.device.type == "cpu" and not is_fake(x):
        return rmsnorm_ref(x, w, eps)
    return RMSNorm.apply(x.contiguous(), w, eps)


# --------------------------------------------------------------------------- #
# the operators
# --------------------------------------------------------------------------- #


@torch.library.custom_op("repro_torch::rmsnorm_fwd", mutates_args=())
def _dispatch_fwd(x: torch.Tensor, w: torch.Tensor,
                  eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    return _launch_fwd(x, w, eps)


@_dispatch_fwd.register_fake
def _(x, w, eps):
    return torch.empty_like(x), x.new_empty(x.shape[:-1], dtype=torch.float32)


@torch.library.custom_op("repro_torch::rmsnorm_bwd", mutates_args=())
def _dispatch_bwd(x: torch.Tensor, w: torch.Tensor, rstd: torch.Tensor,
                  g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return _launch_bwd(x, w, rstd, g)


@_dispatch_bwd.register_fake
def _(x, w, rstd, g):
    return torch.empty_like(x), w.new_empty(w.shape, dtype=torch.float32)


# --------------------------------------------------------------------------- #
# the CUDA launches
# --------------------------------------------------------------------------- #


def _check(x, w, name: str):
    """x's rows ``[n, d]`` and w as the contiguous float32 ``[d]`` the
    kernels read; raises on what they do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    d = x.shape[-1] if x.dim() else 0
    if x.dtype not in _DTYPES or not 1 <= d <= D_MAX:
        raise ValueError(f"the CUDA {name} kernel takes float32 or bfloat16 and a "
                         f"last dim of 1 to {D_MAX}, got {x.dtype} and {d}")
    if not x.is_contiguous() or w.shape != (d,) or w.device != x.device:
        raise ValueError(f"{name}: x must be contiguous and w a [{d}] tensor on "
                         f"{x.device}")
    return x.reshape(-1, d), w.float().contiguous()


def _launch_fwd(x, w, eps: float):
    from .._build import launcher

    x2, w32 = _check(x, w, "rmsnorm_fwd")
    n, d = x2.shape
    y = torch.empty_like(x)
    rstd = x.new_empty(x.shape[:-1], dtype=torch.float32)
    launch = launcher("rmsnorm_fwd_launch", *_FWD_ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = launch(x2.data_ptr(), w32.data_ptr(), y.data_ptr(), rstd.data_ptr(),
                    n, d, eps, _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"rmsnorm_fwd kernel launch failed: cudaError {rc}")
    LAUNCHES["rmsnorm_fwd"] += 1
    return y, rstd


def _launch_bwd(x, w, rstd, g):
    from .._build import launcher

    x2, w32 = _check(x, w, "rmsnorm_bwd")
    n, d = x2.shape
    for name, t, dtype, shape in (("g", g, x.dtype, x.shape),
                                  ("rstd", rstd, torch.float32, x.shape[:-1])):
        if (t.dtype != dtype or t.shape != shape or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"rmsnorm_bwd: {name} must be a contiguous {dtype} "
                             f"tensor of shape {tuple(shape)} on {x.device}")
    dx = torch.empty_like(x)
    dw = torch.empty(d, dtype=torch.float32, device=x.device)
    parts = torch.empty((-(-n // BWD_ROWS), d), dtype=torch.float32, device=x.device)
    launch = launcher("rmsnorm_bwd_launch", *_BWD_ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = launch(x2.data_ptr(), w32.data_ptr(), rstd.data_ptr(), g.data_ptr(),
                    dx.data_ptr(), parts.data_ptr(), dw.data_ptr(), n, d, BWD_ROWS,
                    _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"rmsnorm_bwd kernel launch failed: cudaError {rc}")
    LAUNCHES["rmsnorm_bwd"] += 1
    return dx, dw
