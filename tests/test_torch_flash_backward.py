"""K5's backward: the plain versions of the port (``attention_lse_ref``,
``attention_bwd_ref``) against the JAX package's attention under
``jax.vjp`` and against torch autograd, the bf16 rounding limit, the
operators ``repro_torch::flash_attention_fwd`` and
``repro_torch::flash_attention_backward`` on fake tensors, and, on the
card, the backward kernel (``csrc/flash_attn_bwd.cu``) against
``attention_bwd_ref``.

Inputs are numpy draws from a seed.  In float32 the plain backward agrees
with ``jax.vjp`` of the reference's ``attention_ref`` and with torch
autograd to 1e-5: it recomputes P from the log-sum-exp instead of
normalising the softmax, which moves an element by a few float32 ulps.
The float32 kernel's split-TF32 arithmetic is emulated on the CPU and held,
as the kernel is on the card, to ``attention_bwd_limit`` of the float64
gradients at draws of std 2 and 3.
The cases that need a card are marked ``cuda`` and skip without one; the
reference package is imported inside the helpers, so they also run where
JAX is not installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_flash_backward.py
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels.flash_attn import (
    BWD_BF16_RMS_LIMIT,
    LAUNCHES as FA_LAUNCHES,
    attention_bwd_bf16,
    attention_bwd_bf16_scores,
    attention_bwd_limit,
    attention_bwd_ref,
    attention_bwd_split_tf32,
    attention_bwd_tf32,
    attention_exact,
    attention_lse_ref,
    attention_pairs,
    attention_ref,
    flash_attention_backward,
    flash_attention_fwd,
    mha_flash,
    mha_ref,
    rms_ratio,
)
from repro_torch.kernels.flash_attn.flash_attn import HEAD_DIMS
from repro_torch.kernels.flash_attn.ops import _fold

SRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/flash_attn/csrc"
WINDOWS = [None, 5]


def _draw(seed: int, shape, n: int = 4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _jax_vjp(fn, q, k, v, do):
    import jax
    import jax.numpy as jnp

    out, pull = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(g) for g in pull(jnp.asarray(do))]


def _plain_inputs(q, k, v, window):
    """o (float32) and lse of the plain forward, as the forward kernel
    hands them to the backward."""
    return (attention_ref(q.float(), k.float(), v.float(), window=window),
            attention_lse_ref(q, k, v, window=window))


# --------------------------------------------------------------------------- #
# the plain versions against the reference and torch autograd
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_bwd_ref_matches_jax_vjp(d, s, window):
    from repro.kernels.flash_attn import attention_ref as ref_attention

    q, k, v, do = _draw(d + s + (window or 0), (2, s, d))
    want = _jax_vjp(lambda a, b, c: ref_attention(a, b, c, window=window),
                    q, k, v, do)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    o, lse = _plain_inputs(*t[:3], window)
    got = attention_bwd_ref(t[0], t[1], t[2], o, lse, t[3], window=window)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", WINDOWS)
def test_mha_layout_grads_match_jax_vjp(window):
    """At the model layout ``[B, S, H, D]``: the reference's ``mha_ref``
    under ``jax.vjp`` against the port's ``mha_ref`` and ``mha_flash``
    under autograd and against ``attention_bwd_ref`` on the folded
    tensors."""
    from repro.kernels.flash_attn import mha_ref as ref_mha

    B, S, H, D = 2, 128, 3, 16
    q, k, v, do = _draw(40 + (window or 0), (B, S, H, D))
    want = _jax_vjp(lambda a, b, c: ref_mha(a, b, c, window=window), q, k, v, do)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    for fn in (mha_ref, mha_flash):
        leaves = [x.clone().requires_grad_() for x in t[:3]]
        got = torch.autograd.grad(fn(*leaves, window=window), leaves, t[3])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)
    f = [_fold(x) for x in t]
    o, lse = _plain_inputs(*f[:3], window)
    got = attention_bwd_ref(f[0], f[1], f[2], o, lse, f[3], window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.reshape(B, H, S, D).movedim(1, 2).numpy(),
                                   w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("d", [16, 32, 64])
def test_bwd_ref_matches_torch_autograd(d, window):
    q, k, v, do = (torch.from_numpy(x) for x in _draw(7 * d + (window or 0),
                                                      (3, 192, d)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*leaves, window=window), leaves, do)
    o, lse = _plain_inputs(q, k, v, window)
    got = attention_bwd_ref(q, k, v, o, lse, do, window=window)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("d", [16, 32, 64])
def test_lse_ref_matches_jax_logsumexp(d, window):
    import jax
    import jax.numpy as jnp

    q, k, v = _draw(3 * d + (window or 0), (2, 256, d), n=3)
    S, scale = q.shape[1], 1.0 / np.sqrt(d)
    s = jnp.einsum("bqd,bkd->bqk", jnp.asarray(q), jnp.asarray(k)) * scale
    qpos, kpos = jnp.arange(S)[:, None], jnp.arange(S)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    want = np.asarray(jax.nn.logsumexp(jnp.where(mask[None], s, -1e30), axis=-1))
    got = attention_lse_ref(*(torch.from_numpy(x) for x in (q, k, v)), window=window)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, S)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("d", [32, 64])
def test_bwd_limit_holds_float32_against_float64(d, window):
    """``attention_bwd_limit`` holds the plain backward in float32 against
    the same in float64: summation order and rounding alone stay inside,
    and the limit is a small share of the gradients' size."""
    q, k, v, do = (torch.from_numpy(x) for x in _draw(11 * d, (2, 320, d)))
    o, lse = _plain_inputs(q, k, v, window)
    got = attention_bwd_ref(q, k, v, o, lse, do, window=window)
    want = attention_bwd_ref(*(x.double() for x in (q, k, v, o, lse, do)),
                             window=window)
    lims = attention_bwd_limit(q, k, v, o, lse, do, window=window)
    for g, w, lim in zip(got, want, lims):
        assert w.dtype == torch.float64
        assert bool(((g.double() - w).abs() <= lim).all())
        assert float(lim.mean()) < 2e-3 * float(w.abs().mean())


# the shapes of the split-TF32 readings: every head dim, S 64 and 1,024,
# windows none and 40
SPLIT_SHAPES = [(s, d, w) for d in (32, 64, 96, 128) for s in (64, 1024)
                for w in (None, 40)]


def _f32_case(s, d, window):
    q, k, v, do = (torch.from_numpy(x) for x in _draw(s + d + (window or 0), (2, s, d)))
    o, lse = _plain_inputs(q, k, v, window)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("s,d,window", SPLIT_SHAPES)
def test_bwd_split_tf32_stays_within_float32_limit(s, d, window):
    """The float32 kernel's five products as split TF32 keep dq, dk and dv
    within ``attention_bwd_limit`` of the plain backward."""
    args = _f32_case(s, d, window)
    want = attention_bwd_ref(*args, window=window)
    got = attention_bwd_split_tf32(*args, window=window)
    lims = attention_bwd_limit(*args, window=window)
    for g, w, lim in zip(got, want, lims):
        assert g.dtype == torch.float32
        assert bool(((g - w).abs() <= lim).all())


@pytest.mark.parametrize("s,d,window", SPLIT_SHAPES)
def test_bwd_one_tf32_product_exceeds_float32_limit(s, d, window):
    """The control, one TF32 product each, exceeds ``attention_bwd_limit``
    several times over in dq, dk and dv."""
    args = _f32_case(s, d, window)
    want = attention_bwd_ref(*args, window=window)
    got = attention_bwd_tf32(*args, window=window)
    lims = attention_bwd_limit(*args, window=window)
    for g, w, lim in zip(got, want, lims):
        assert float(((g - w).abs() / lim).max()) > 4


def _scaled_case(s, d, window, std, device="cpu", bh=2):
    """q, k, v of std ``std`` and dO of std 1 (float32), o and lse of the
    float64 answer: the float32 arguments and the same as float64."""
    rng = np.random.default_rng(s + d + (window or 0))
    q, k, v, do = (torch.from_numpy(rng.standard_normal((bh, s, d)).astype(np.float32))
                   .to(device) for _ in range(4))
    q, k, v = q * std, k * std, v * std
    o, lse = attention_exact(q, k, v, window=window)
    args64 = (q.double(), k.double(), v.double(), o, lse, do.double())
    return tuple(x.float() for x in args64), args64


def _worst_share(got, want, lims) -> float:
    return max(float(((g.double() - w).abs() / lim).max())
               for g, w, lim in zip(got, want, lims))


@pytest.mark.parametrize("std", [2.0, 3.0])
@pytest.mark.parametrize("s,d,window", SPLIT_SHAPES)
def test_bwd_split_tf32_holds_float32_limit_against_float64(s, d, window, std):
    """At draws of std 2 and 3 the split keeps dq, dk and dv within
    ``attention_bwd_limit`` of the float64 gradients, within twice the
    plain float32 backward's error; one TF32 product is 50 times over."""
    args, args64 = _scaled_case(s, d, window, std)
    want = attention_bwd_ref(*args64, window=window)
    lims = attention_bwd_limit(*args, window=window)
    split = _worst_share(attention_bwd_split_tf32(*args, window=window), want, lims)
    plain = _worst_share(attention_bwd_ref(*args, window=window), want, lims)
    assert split <= 1 and split <= 2 * plain
    assert _worst_share(attention_bwd_tf32(*args, window=window), want, lims) > 50 * plain


def test_padded_keys_get_zero_grads():
    """Keys after every real query, with the padded queries' dO zero (as
    ``layers.flash_causal`` slices them off), get dk = dv = 0 exactly."""
    S, Sp, D = 200, 256, 32
    q, k, v, do = (torch.from_numpy(x) for x in _draw(5, (2, Sp, D)))
    for x in (q, k, v, do):
        x[:, S:] = 0
    o, lse = _plain_inputs(q, k, v, None)
    dq, dk, dv = attention_bwd_ref(q, k, v, o, lse, do)
    assert not bool(dk[:, S:].any()) and not bool(dv[:, S:].any())
    assert bool(dk[:, :S].any()) and bool(dv[:, :S].any())


# --------------------------------------------------------------------------- #
# the bf16 kernel's rounding
# --------------------------------------------------------------------------- #

# the shapes ``scripts/k5_bwd_bf16_limit.py`` reads (but S = 4,096, which
# that script also reads), with its seeds
BF16_SHAPES = [(s, d, w) for d in (32, 64, 96, 128) for s in (64, 288, 1024)
               for w in (None, 40, 100)]


def _bf16_case(s, d, window, bh: int = 2):
    rng = np.random.default_rng(s + d + (window or 0))
    q, k, v, do = (torch.from_numpy(rng.standard_normal((bh, s, d)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(4))
    o, lse = _plain_inputs(q, k, v, window)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("s,d,window", BF16_SHAPES)
def test_bwd_bf16_rms_limit_passes_kernel_fails_control(s, d, window):
    """P and dS rounded to bf16 stay within ``BWD_BF16_RMS_LIMIT`` in each
    gradient; the control that also rounds the scores does not."""
    args = _bf16_case(s, d, window)
    want = attention_bwd_ref(*args, window=window)
    kernel = attention_bwd_bf16(*args, window=window)
    control = attention_bwd_bf16_scores(*args, window=window)
    assert all(g.dtype == torch.bfloat16 for g in kernel)
    assert max(rms_ratio(a, b) for a, b in zip(kernel, want)) <= BWD_BF16_RMS_LIMIT
    assert min(rms_ratio(a, b) for a, b in zip(control, want)) > BWD_BF16_RMS_LIMIT


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_bwd_bf16_needs_float32_o(d, window):
    """Why the forward hands the backward a float32 o: where V shares a
    large component across keys, dP - delta cancels to a small dS, and
    delta = rowsum(dO o) from an o rounded to bf16 carries an error of the
    size of that component.  With the float32 o the kernel's roundings stay
    within ``BWD_BF16_RMS_LIMIT``; with o in bf16 dq and dk are off by more
    than ten times the limit, while dv, which does not read delta, is
    unchanged."""
    s = 256
    rng = np.random.default_rng(d + s)
    q, k, do = (torch.from_numpy(rng.standard_normal((2, s, d)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    common = rng.standard_normal((1, 1, d)).astype(np.float32)
    v = torch.from_numpy(common + 0.02 * rng.standard_normal((2, s, d)).astype(
        np.float32)).to(torch.bfloat16)
    o, lse = _plain_inputs(q, k, v, window)
    want = attention_bwd_ref(q, k, v, o, lse, do, window=window)
    f32_o = attention_bwd_bf16(q, k, v, o, lse, do, window=window)
    bf16_o = attention_bwd_bf16(q, k, v, o.to(torch.bfloat16).float(), lse, do,
                                window=window)
    assert max(rms_ratio(a, b) for a, b in zip(f32_o, want)) <= BWD_BF16_RMS_LIMIT
    assert min(rms_ratio(a, b) for a, b in zip(bf16_o[:2], want[:2])) > \
        10 * BWD_BF16_RMS_LIMIT
    assert torch.equal(bf16_o[2], f32_o[2])


# --------------------------------------------------------------------------- #
# the operators
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_operators_on_fake_tensors(dtype, window):
    """On fake tensors the operators only shape their outputs; their FLOP
    formulas are the kernels' work: 4 D and 10 D per unmasked pair and
    head."""
    BH, S, D = 6, 256, 64
    with FakeTensorMode():
        q = torch.empty((BH, S, D), dtype=dtype)
        with FlopCounterMode(display=False) as fwd:
            o, lse = flash_attention_fwd(q, q, q, window=window)
        with FlopCounterMode(display=False) as bwd:
            dq, dk, dv = flash_attention_backward(q, q, q, o, lse, q, window=window)
    assert o.shape == q.shape and o.dtype == torch.float32
    assert lse.shape == (BH, S) and lse.dtype == torch.float32
    assert all(g.shape == q.shape and g.dtype == dtype for g in (dq, dk, dv))
    pairs = attention_pairs(S, window)
    assert fwd.get_total_flops() == 4 * D * BH * pairs
    assert bwd.get_total_flops() == 10 * D * BH * pairs


def test_node_on_fake_tensors_takes_the_operators():
    """Under ``FakeTensorMode`` (the dry run's tensors, on the CPU device)
    the autograd node runs the kernels' operators, not the plain version:
    a forward and a backward count 4 D + 10 D per pair and head."""
    B, S, H, D = 2, 128, 3, 32
    with FakeTensorMode():
        leaves = [torch.empty((B, S, H, D)).requires_grad_() for _ in range(3)]
        with FlopCounterMode(display=False) as fc:
            out = mha_flash(*leaves)
            torch.autograd.grad(out, leaves, torch.ones_like(out))
    counts = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    pairs = attention_pairs(S)
    assert counts == {"repro_torch.flash_attention_fwd": 4 * D * B * H * pairs,
                      "repro_torch.flash_attention_backward": 10 * D * B * H * pairs}


def test_operators_cpu_routes_are_the_plain_versions():
    q, k, v, do = (torch.from_numpy(x) for x in _draw(9, (2, 128, 32)))
    FA_LAUNCHES["flash_attention_backward"] = 0
    o, lse = flash_attention_fwd(q.bfloat16(), k.bfloat16(), v.bfloat16(), window=5)
    assert o.dtype == torch.float32  # not rounded to the inputs' bf16
    torch.testing.assert_close(o, attention_ref(q.bfloat16().float(), k.bfloat16().float(),
                                                v.bfloat16().float(), window=5),
                               rtol=0, atol=0)
    o, lse = flash_attention_fwd(q, k, v, window=5)
    torch.testing.assert_close(o, attention_ref(q, k, v, window=5), rtol=0, atol=0)
    torch.testing.assert_close(lse, attention_lse_ref(q, k, v, window=5),
                               rtol=0, atol=0)
    got = flash_attention_backward(q, k, v, o, lse, do, window=5)
    for g, w in zip(got, attention_bwd_ref(q, k, v, o, lse, do, window=5)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert FA_LAUNCHES["flash_attention_backward"] == 0


def test_backward_rejects_bad_operands():
    x = torch.zeros((2, 128, 32))
    lse = torch.zeros((2, 128))
    with pytest.raises(ValueError):
        flash_attention_backward(x, x, x, x, lse, torch.zeros((2, 64, 32)))
    with pytest.raises(ValueError):
        flash_attention_backward(x, x, x, x, torch.zeros((2, 64)), x)
    with pytest.raises(ValueError):
        flash_attention_backward(x, x, x, x, lse, x, window=0)


def test_backward_launcher_matches_wrapper():
    """The backward launcher takes the forward's head dims, and its C
    signature has as many parameters as the wrapper declares."""
    from repro_torch.kernels.flash_attn.flash_attn import _ARGS, _BWD_ARGS

    for path, name, argtypes in (("flash_attn.cu", "flash_attention_launch", _ARGS),
                                 ("flash_attn_bwd.cu", "flash_attention_bwd_launch",
                                  _BWD_ARGS)):
        src = (SRC / path).read_text()
        launcher = src[src.index(f'extern "C" int {name}('):]
        params = launcher[launcher.index("(") + 1:launcher.index(")")]
        assert len(params.split(",")) == len(argtypes), name
        guard = launcher[:launcher.index("cudaErrorInvalidValue")]
        assert tuple(map(int, re.findall(r"d != (\d+)", guard))) == HEAD_DIMS
        cases = re.findall(r"case (\d+): return launch<(\d+)>", launcher)
        default = re.findall(r"default: return launch<(\d+)>", launcher)
        assert all(a == b for a, b in cases)
        assert tuple(int(a) for a, _ in cases) + tuple(map(int, default)) == HEAD_DIMS


# --------------------------------------------------------------------------- #
# the CUDA kernel against its plain version (needs a card)
# --------------------------------------------------------------------------- #


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _card_case(device, s, d, window, dtype, bh=3, seed=0):
    """q, k, v, dO on the card, o (float32) and lse from the forward
    kernel (which takes any S; ``bq = bk = 1`` only passes the reference's
    block-multiple check)."""
    rng = np.random.default_rng(seed + s + d + (window or 0))
    q, k, v, do = (torch.from_numpy(rng.standard_normal((bh, s, d)).astype(
        np.float32)).to(device, dtype) for _ in range(4))
    o, lse = flash_attention_fwd(q, k, v, window=window, bq=1, bk=1)
    return q, k, v, o, lse, do


def _within(got, want, args, window, dtype):
    if dtype == torch.float32:
        lims = attention_bwd_limit(*args, window=window)
        return all(bool(((g.float() - w.float()).abs() <= lim).all())
                   for g, w, lim in zip(got, want, lims))
    return all(rms_ratio(g, w) <= BWD_BF16_RMS_LIMIT for g, w in zip(got, want))


def _check_backward(args, window, dtype):
    """The forward's lse within 2e-5 (1 + |lse|) of the plain version's,
    one backward launch, and dq, dk, dv within ``attention_bwd_limit``
    (float32) or ``BWD_BF16_RMS_LIMIT`` (bf16) of ``attention_bwd_ref`` on
    the same inputs."""
    q, k, v, o, lse, do = args
    want_lse = attention_lse_ref(q, k, v, window=window)
    assert bool(((lse - want_lse).abs() <= 2e-5 * (1 + want_lse.abs())).all())
    before = dict(FA_LAUNCHES)
    got = flash_attention_backward(*args, window=window)
    torch.cuda.synchronize()
    assert FA_LAUNCHES["flash_attention_backward"] == before["flash_attention_backward"] + 1
    assert FA_LAUNCHES["flash_attention"] == before["flash_attention"]
    assert all(g.dtype == dtype and g.shape == q.shape for g in got)
    want = attention_bwd_ref(*args, window=window)
    assert _within(got, want, args, window, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 40, 100, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("s", [64, 129, 200, 288, 1024])
def test_cuda_backward_matches_plain(cuda_device, s, d, dtype, window,
                                     monkeypatch):
    """Every head dim, type and window (128: on the bf16 kernel's tile
    edges), S ragged against the 128- and 64-row tiles (129, 200, 288) or
    not: :func:`_check_backward`."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    _check_backward(_card_case(cuda_device, s, d, window, dtype), window, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,window", [(28, None), (25, 2048)])
def test_cuda_backward_at_training_shape(cuda_device, bh, window, monkeypatch):
    """qwen2-0.5b's training shape (BH 28, S 4,096, D 64, bf16) and
    hymba-1.5b's window of 2,048 at S 4,096: :func:`_check_backward`."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    args = _card_case(cuda_device, 4096, 64, window, torch.bfloat16, bh=bh)
    _check_backward(args, window, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,window", [(28, None), (25, 2048)])
def test_cuda_backward_float32_at_training_shape(cuda_device, bh, window, monkeypatch):
    """The split-TF32 backward at qwen2-0.5b's training shape (BH 28, S
    4,096, D 64) and with hymba-1.5b's window of 2,048:
    :func:`_check_backward`, within ``attention_bwd_limit``."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    args = _card_case(cuda_device, 4096, 64, window, torch.float32, bh=bh)
    _check_backward(args, window, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("s,d,window", [(129, 64, 2048), (200, 128, 2048),
                                        (1024, 32, 2048), (1024, 96, 128)])
def test_cuda_backward_float32_windows(cuda_device, s, d, window, monkeypatch):
    """Windows of 128 and 2,048 (wider than S) on ragged and whole tiles:
    :func:`_check_backward` in float32."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    _check_backward(_card_case(cuda_device, s, d, window, torch.float32), window,
                    torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("std", [2.0, 3.0])
@pytest.mark.parametrize("bh,s,d,window", [
    (2, 1024, 128, None), (3, 1024, 64, 40), (2, 200, 96, None), (4, 4096, 64, None)])
def test_cuda_backward_float32_against_float64(cuda_device, bh, s, d, window, std,
                                               monkeypatch):
    """The split-TF32 backward at draws of std 2 and 3 keeps dq, dk and dv
    within ``attention_bwd_limit`` of the float64 gradients (o and lse of
    the float64 answer)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    args, args64 = _scaled_case(s, d, window, std, device=cuda_device, bh=bh)
    got = flash_attention_backward(*args, window=window)
    want = attention_bwd_ref(*args64, window=window)
    assert _worst_share(got, want, attention_bwd_limit(*args, window=window)) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,d", [(4, 512, 64), (3, 200, 128), (28, 4096, 64)])
@pytest.mark.parametrize("window", [None, 100, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_is_deterministic(cuda_device, dtype, window, bh, s, d):
    """Two runs on the same inputs give the same bits (no atomics), S on
    the tiles or ragged, up to qwen2-0.5b's training shape."""
    args = _card_case(cuda_device, s, d, window, dtype, bh=bh)
    first = flash_attention_backward(*args, window=window)
    second = flash_attention_backward(*args, window=window)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_rejects_other_head_dims(cuda_device, dtype):
    q = torch.zeros((2, 128, 48), dtype=dtype, device=cuda_device)
    lse = torch.zeros((2, 128), device=cuda_device)
    before = FA_LAUNCHES["flash_attention_backward"]
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_backward(q, q, q, q, lse, q)
    assert FA_LAUNCHES["flash_attention_backward"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_padded_keys_get_zero_grads(cuda_device, dtype, monkeypatch):
    """``layers.flash_causal`` pads S = 200 to 256: the backward kernel's
    dk and dv of the padded keys are exactly 0, and the gradients of the
    real positions match the plain route's."""
    from repro_torch.kernels.flash_attn import ops
    from repro_torch.models import layers

    seen = []
    real = ops.flash_attention_backward

    def keep(*a, **kw):
        out = real(*a, **kw)
        seen.append(out)
        return out

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(ops, "flash_attention_backward", keep)
    B, S, H, D = 2, 200, 2, 64
    x = [torch.from_numpy(a).to(cuda_device, dtype)
         for a in _draw(21, (B, S, H, D))]
    leaves = [a.clone().requires_grad_() for a in x[:3]]
    got = torch.autograd.grad(layers.flash_causal(*leaves), leaves, x[3])
    assert len(seen) == 1
    _, dk, dv = seen[0]
    assert dk.shape[1] == 256
    assert not bool(dk[:, S:].any()) and not bool(dv[:, S:].any())
    plain = [a.clone().requires_grad_() for a in x[:3]]
    want = torch.autograd.grad(mha_ref(*plain), plain, x[3])
    for g, w in zip(got, want):
        assert rms_ratio(g, w) <= (1e-5 if dtype == torch.float32 else BWD_BF16_RMS_LIMIT)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 40])
def test_cuda_node_launches_each_kernel_once(cuda_device, window, monkeypatch):
    """``mha_flash`` under autograd on the card: one forward launch (with
    its lse), one backward launch, and the plain route's gradients (autograd
    through ``attention_ref``) within RMS 1e-5; without a gradient (prefill)
    the forward alone."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    B, S, H, D = 1, 256, 4, 64
    x = [torch.from_numpy(a).to(cuda_device) for a in _draw(22, (B, S, H, D))]
    before = dict(FA_LAUNCHES)
    leaves = [a.clone().requires_grad_() for a in x[:3]]
    got = torch.autograd.grad(mha_flash(*leaves, window=window), leaves, x[3])
    torch.cuda.synchronize()
    assert FA_LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert FA_LAUNCHES["flash_attention_backward"] == \
        before["flash_attention_backward"] + 1
    plain = [a.clone().requires_grad_() for a in x[:3]]
    want = torch.autograd.grad(mha_ref(*plain, window=window), plain, x[3])
    for g, w in zip(got, want):
        assert rms_ratio(g, w) <= 1e-5
    with torch.no_grad():
        mha_flash(*x[:3], window=window)
    assert FA_LAUNCHES["flash_attention_backward"] == \
        before["flash_attention_backward"] + 1


def test_library_path_follows_the_shared_header(tmp_path, monkeypatch):
    """Both K5 sources include ``csrc/tensor_core.cuh`` (through
    ``hopper.cuh``): an edit of the header alone must name another library,
    so no stale binary loads."""
    import shutil

    from repro_torch.kernels import _build

    for src in _build.sources() + sorted(_build._KERNELS.glob("*/csrc/*.cuh")):
        dst = tmp_path / src.relative_to(_build._KERNELS)
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src, dst)
    monkeypatch.setattr(_build, "_KERNELS", tmp_path)
    assert [p.name for p in _build.sources()].count("tensor_core.cuh") == 0
    before = _build._library_path()
    header = tmp_path / "flash_attn/csrc/tensor_core.cuh"
    header.write_text(header.read_text() + "\n")
    assert _build._library_path() != before


def test_library_path_follows_the_hopper_header(tmp_path, monkeypatch):
    """The backward's wgmma, TMA and mbarrier helpers live in
    ``csrc/hopper.cuh``: an edit of it alone names another library."""
    import shutil

    from repro_torch.kernels import _build

    for src in _build.sources() + sorted(_build._KERNELS.glob("*/csrc/*.cuh")):
        dst = tmp_path / src.relative_to(_build._KERNELS)
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src, dst)
    monkeypatch.setattr(_build, "_KERNELS", tmp_path)
    before = _build._library_path()
    header = tmp_path / "flash_attn/csrc/hopper.cuh"
    header.write_text(header.read_text() + "\n")
    assert _build._library_path() != before


_PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__525bf55f_17_flash_attn_bwd_cu_41c6651719flash_bwd_dkdv_bf16ILi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_iiff' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__525bf55f_17_flash_attn_bwd_cu_41c6651719flash_bwd_dkdv_bf16ILi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_iiff
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 896 bytes cmem[0]
ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions are serialized due to insufficient register resources for the function '_ZN50_GLOBAL__N__525bf55f_17_flash_attn_bwd_cu_41c6651719flash_bwd_dkdv_bf16ILi128EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_iiff'
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__525bf55f_17_flash_attn_bwd_cu_41c6651719flash_bwd_dkdv_bf16ILi128EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_iiff' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__525bf55f_17_flash_attn_bwd_cu_41c6651719flash_bwd_dkdv_bf16ILi128EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_iiff
    88 bytes stack frame, 84 bytes spill stores, 84 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1024 bytes smem, 896 bytes cmem[0]
ptxas info    : Compiling entry function 'pred_filter_kernel' for 'sm_90a'
ptxas info    : Used 40 registers, 380 bytes cmem[0]
"""

_SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN50_GLOBAL__N__525bf55f_17_flash_attn_bwd_cu_41c6651717flash_bwd_dq_bf16ILi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16iiff
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                        /* 0x00000a00ff017b82 */
        /*0f30*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ; /* 0x01e00000041879f0 */
        /*0f40*/              @P0  UTMALDG.3D [UR8], [UR14] ;                    /* 0x00000008080075b4 */
        /*0f50*/             @!UP0 UTMALDG.3D [UR16], [UR14] ;                   /* 0x00000008080075b4 */
\t\tFunction : _ZN12_GLOBAL__N_120flash_attention_bf16ILi64EfEEvPKT_
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;          /* 0x0000000c0804723c */
"""


def test_ptxas_resources_by_kernel():
    """``_build.resources`` reads each kernel's registers, stack, spills
    and static shared memory from ``ptxas -v`` and keeps the warnings that
    name it (a serialized wgmma pipeline) under the demangled name."""
    from repro_torch.kernels._build import resources

    got = resources(_PTXAS)
    assert got["flash_bwd_dkdv_bf16<64>"] == {
        "warnings": [], "stack": 0, "spill_stores": 0, "spill_loads": 0,
        "registers": 168, "static_smem": 0}
    big = got["flash_bwd_dkdv_bf16<128>"]
    assert (big["stack"], big["spill_stores"], big["spill_loads"],
            big["registers"], big["static_smem"]) == (88, 84, 84, 168, 1024)
    assert len(big["warnings"]) == 1 and "serialized" in big["warnings"][0]
    assert got["pred_filter_kernel"]["registers"] == 40


def test_sass_counts_by_kernel():
    """``_build.sass_counts`` counts opcodes per function of ``cuobjdump
    -sass`` output, predicated or not, and tells HGMMA from HMMA."""
    from repro_torch.kernels._build import sass_counts

    got = sass_counts(_SASS, ("HGMMA", "UTMALDG", "HMMA"))
    assert got["flash_bwd_dq_bf16<64>"] == {"HGMMA": 1, "UTMALDG": 2, "HMMA": 0}
    # a type among the template arguments is named too
    other = [k for k in got if "flash_attention_bf16" in k]
    assert other == ["flash_attention_bf16<64, float>"] and got[other[0]]["HMMA"] == 1


@pytest.mark.parametrize("mangled,name", [
    ("_ZN46_GLOBAL__N__525bf55f_17_flash_attn_cu_41c6651720flash_attention_bf16"
     "ILi128E13__nv_bfloat16EEv14CUtensorMap_stS1_S1_PT0_Pfiif",
     "flash_attention_bf16<128, __nv_bfloat16>"),
    ("_ZN12_GLOBAL__N_115flash_bwd_deltaIfLi64EEEvPKfPKT_Pfl", "flash_bwd_delta<float, 64>"),
    ("_ZN12_GLOBAL__N_116flash_bwd_dq_f32ILi32EEEv14CUtensorMap_st", "flash_bwd_dq_f32<32>"),
    ("_ZN12_GLOBAL__N_111kmajor_copyEPKfPfiii", "_ZN12_GLOBAL__N_111kmajor_copyEPKfPfiii"),
    ("pred_filter_kernel", "pred_filter_kernel")])
def test_kernel_names_with_type_arguments(mangled, name):
    """``_build._kernel_name`` spells out integer, float and named template
    arguments in order (``chip_smoke.py`` keys the bf16 forward's
    instances by them) and leaves a name it cannot read as it is."""
    from repro_torch.kernels._build import _kernel_name

    assert _kernel_name(mangled) == name


def test_bf16_backward_smem_entry_point():
    """``chip_smoke.py`` reads the bf16 kernels' dynamic shared memory
    through ``flash_attention_bwd_bf16_smem(int d, int dq_pass)``, which
    answers every head dim the launcher takes and -1 for others."""
    src = (SRC / "flash_attn_bwd.cu").read_text()
    fn = src[src.index('extern "C" int flash_attention_bwd_bf16_smem('):]
    fn = fn[:fn.index("\n}\n")]
    assert fn[fn.index("(") + 1:fn.index(")")] == "int d, int dq_pass"
    assert tuple(map(int, re.findall(r"case (\d+):", fn))) == HEAD_DIMS
    assert "default: return -1;" in fn
