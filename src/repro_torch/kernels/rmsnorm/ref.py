"""Plain PyTorch versions of RMSNorm: the eager op the port ran before its
kernels (:func:`rmsnorm_ref`, on the CPU still the port's norm), the
kernels' arithmetic written out in float32 (:func:`rmsnorm_fwd_ref`,
:func:`rmsnorm_bwd_ref`), the gradients in float64
(:func:`rmsnorm_bwd_exact`) and the limits the kernels are held to."""

from __future__ import annotations

import torch

# RMS of (kernel - float64) over RMS of the float64 gradient.  dx in bf16:
# each element is rounded once to bf16, at most 2^-8 of itself, so the
# ratio is at most 2^-8; the float32 arithmetic before it adds about 1e-6.
# dx in float32 and dw (float32 in both types): a few float32 roundings of
# each term and float32 sums of d (dx) or of every row (dw: 16,384 at the
# training shape), 1e-7 to 1e-5 of the gradient; 1e-4 leaves room for the
# sums' cancellation where g has both signs.
DX_LIMIT = {torch.bfloat16: 2.0 ** -8, torch.float32: 1e-5}
DW_LIMIT = 1e-4


def rmsnorm_fwd_ref(x, w, eps: float):
    """``(y, rstd)``: y = x / sqrt(mean(x^2) + eps) rounded to x's type,
    times w in x's type; rstd the float32 ``1 / sqrt(mean(x^2) + eps)`` of
    each row (shape ``x.shape[:-1]``), which the backward reads."""
    x32 = x.float()
    rstd = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rstd).to(x.dtype) * w.to(x.dtype), rstd[..., 0]


def rmsnorm_ref(x, w, eps: float):
    """RMSNorm over the last dim, in float32 and rounded to x's type before
    the weight (cast to x's type) multiplies it."""
    return rmsnorm_fwd_ref(x, w, eps)[0]


def rmsnorm_bwd_ref(x, w, rstd, g):
    """``(dx, dw)`` of :func:`rmsnorm_ref` from x, w, the forward's rstd
    and the output's gradient g, in float32 as the backward kernel forms
    them: with w~ = w in x's type and r = rstd,
    ``dx = r (g w~) - x r^3 / d sum(g w~ x)`` (in x's type), and
    ``dw = sum over rows of g t`` (float32) with t = x r rounded to x's
    type, the forward's own t."""
    d = x.shape[-1]
    x32, g32, r = x.float(), g.float(), rstd.float()[..., None]
    gw = g32 * w.to(x.dtype).float()
    s = (gw * x32).sum(dim=-1, keepdim=True)
    dx = r * gw - x32 * (s * r * r * r / d)
    t = (x32 * r).to(x.dtype).float()
    return dx.to(x.dtype), (g32 * t).reshape(-1, d).sum(dim=0)


def rmsnorm_bwd_exact(x, w, rstd, g, eps: float):
    """dx and dw in float64 from the same values: dx of the unrounded
    function (x, w~ and g as stored; r in float64), dw the rows' sum of g
    times the forward's t (as the kernel's r rounds it)."""
    d = x.shape[-1]
    x64, g64 = x.double(), g.double()
    w64 = w.to(x.dtype).double()
    r64 = torch.rsqrt((x64 * x64).mean(-1, keepdim=True) + eps)
    gw = g64 * w64
    dx = r64 * gw - x64 * r64 ** 3 / d * (gw * x64).sum(-1, keepdim=True)
    t = (x.float() * rstd[..., None]).to(x.dtype).double()
    return dx, (g64 * t).reshape(-1, d).sum(0)


def rms_ratio(got, want) -> float:
    """RMS of ``got - want`` over RMS of ``want``, in float64."""
    want = want.double()
    return float((got.double() - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())


def bf16_ulp(v):
    """The spacing of bf16 values at |v| (at the smallest normal below it)."""
    e = torch.floor(torch.log2(v.float().abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


def forward_gaps(x, w, eps: float, y, rstd) -> dict:
    """How far a forward's ``(y, rstd)`` lies from :func:`rmsnorm_fwd_ref`:
    ``own_rounding``, whether y is, bit for bit, the eager op's rounding
    of its own r (t = x r rounded to x's type, then t w~ rounded);
    ``rstd_rel``, the largest relative gap of r; ``t_ulps``, the largest
    gap of t in bf16 ulps of the plain t; ``same_where_t_same``, whether y
    equals the plain y wherever the two t are equal.  The kernels' only
    allowed difference is the sum's order: r within 1e-6 (two float32 sums
    of d squares in different orders), t within one ulp, y then exact."""
    want_y, want_r = rmsnorm_fwd_ref(x, w, eps)
    t = (x.float() * rstd[..., None]).to(x.dtype)
    want_t = (x.float() * want_r[..., None]).to(x.dtype).float()
    same = t.float() == want_t
    return {"own_rounding": bool(torch.equal(y, t * w.to(x.dtype))),
            "rstd_rel": float(((rstd - want_r).abs() / want_r).max()),
            "t_ulps": float(((t.float() - want_t).abs() / bf16_ulp(want_t)).max()),
            "same_where_t_same": bool(torch.equal(y[same], want_y[same]))}
