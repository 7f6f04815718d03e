"""RMSNorm's kernel pair (``kernels/rmsnorm``) and the model's norm
(``models/layers.py`` ``rmsnorm``) that runs through it.

On the CPU: the model's norm equals the eager op it replaced bit for bit,
forward and both gradients; on fake tensors it takes the operators, which
shape their outputs only; DTensors run it on each rank's rows; the backward's
formula, written out in float32 (``ref.rmsnorm_bwd_ref``), agrees with
autograd through the plain version; the JAX package's ``rmsnorm`` and its
``jax.vjp`` agree with the plain versions at the training shape, and with
the answers stored in ``tests/data/rmsnorm_jax.npz``.  On the card (marked
``cuda``, skipped without one) the kernels are held to the plain version:
the forward's rounding points, dx and dw against float64 and against the
stored JAX answers (the machine with the card has no JAX), bit-equal
reruns, the raises, the launch count, and a training microbatch's norm
calls, all through the kernels:

    python -m pytest -q --noconftest -m cuda tests/test_torch_rmsnorm.py
"""

from __future__ import annotations

import re
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels import rmsnorm as K
from repro_torch.kernels.rmsnorm.ref import (DW_LIMIT, DX_LIMIT, bf16_ulp, forward_gaps,
                                             rms_ratio, rmsnorm_bwd_exact)
from repro_torch.models import layers as L

SRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu"
JAX_ANSWERS = Path(__file__).resolve().parent / "data" / "rmsnorm_jax.npz"
EPS = 1e-6
DTYPES = [torch.float32, torch.bfloat16]


def eager_rmsnorm(x, w, eps: float):
    """The model's norm as it was written before the kernels, verbatim."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def _draw(shape, dtype, seed: int, device="cpu"):
    """x, w (float32, ``1 + 0.1 z`` as the benchmark draws norms) and the
    output's gradient g, from numpy draws."""
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    w = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(device, dtype), w.to(device), g.to(device, dtype)


def _grads(fn, x, w, g):
    """(y, dx, dw) of ``fn(x, w, EPS)`` for the output's gradient g."""
    xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
    y = fn(xl, wl, EPS)
    dx, dw = torch.autograd.grad(y, (xl, wl), g)
    return y.detach(), dx, dw


# --------------------------------------------------------------------------- #
# CPU
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("d", [64, 896, 900])
@pytest.mark.parametrize("shape", [(2, 9), (3, 1)], ids=["BSd", "B1d"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_route_is_the_eager_op_bit_for_bit(shape, d, dtype):
    """On CPU tensors the model's norm is the plain version: y, dx and dw
    equal the eager op's bit for bit, ``[B, S, d]`` and decode's
    ``[B, 1, d]``."""
    x, w, g = _draw(shape + (d,), dtype, seed=d + shape[1])
    got = _grads(L.rmsnorm, x, w, g)
    want = _grads(eager_rmsnorm, x, w, g)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fake_route_takes_the_operators(dtype):
    """On fake tensors (the dry run's) the model's norm is the autograd node
    over ``repro_torch::rmsnorm_fwd`` / ``rmsnorm_bwd``: y and dx in x's
    type and shape, dw float32 ``[d]`` (the weight's type), rstd a float32
    row; the operators run nothing."""
    seen = []

    class Ops(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func._overloadpacket))
            return func(*args, **(kwargs or {}))

    with FakeTensorMode():
        x = torch.empty((4, 16, 96), dtype=dtype, requires_grad=True)
        w = torch.empty(96, requires_grad=True)
        with Ops():
            y = L.rmsnorm(x, w, EPS)
            y.backward(torch.empty_like(y))
        assert (y.shape, y.dtype) == (x.shape, dtype)
        assert (x.grad.shape, x.grad.dtype) == (x.shape, dtype)
        assert (w.grad.shape, w.grad.dtype) == ((96,), torch.float32)
        y2, rstd = torch.ops.repro_torch.rmsnorm_fwd(x, w, EPS)
        assert (rstd.shape, rstd.dtype) == ((4, 16), torch.float32)
        dx, dw = torch.ops.repro_torch.rmsnorm_bwd(x, w, rstd, y2)
        assert (dx.shape, dx.dtype, dw.shape, dw.dtype) == (x.shape, dtype, (96,),
                                                            torch.float32)
    assert seen.count("repro_torch.rmsnorm_fwd") == 1
    assert seen.count("repro_torch.rmsnorm_bwd") == 1


@pytest.mark.parametrize("d", [64, 896, 900])
def test_backward_formula_against_autograd(d):
    """The backward kernel's formula in plain float32
    (``ref.rmsnorm_bwd_ref``: dx = r (g w) - x r^3 / d sum(g w x), dw the
    rows' sum of g t) against autograd through the plain version in float32
    and in float64: within 1e-5 of the gradients' largest value (float32
    sums of d products against autograd's own order)."""
    x, w, g = _draw((3, 7, d), torch.float32, seed=d)
    _, rstd = K.rmsnorm_fwd_ref(x, w, EPS)
    dx, dw = K.rmsnorm_bwd_ref(x, w, rstd, g)
    assert dx.dtype == torch.float32 and dw.shape == (d,)
    for t in (torch.float32, torch.float64):
        _, want_dx, want_dw = _grads(K.rmsnorm_ref, x.to(t), w.to(t), g.to(t))
        for got, want in ((dx, want_dx), (dw, want_dw)):
            err = (got.double() - want.double()).abs().max()
            assert err <= 1e-5 * want.double().abs().max(), (t, err)


def test_backward_formula_in_bf16_recomputes_the_forward_t():
    """In bf16 the formula's dw is the rows' float32 sum of g times the
    forward's own t = bf16(x r), not of x r."""
    x, w, g = _draw((5, 64), torch.bfloat16, seed=3)
    y, rstd = K.rmsnorm_fwd_ref(x, w, EPS)
    t = (x.float() * rstd[:, None]).to(torch.bfloat16)
    assert torch.equal(y, t * w.to(torch.bfloat16))
    dx, dw = K.rmsnorm_bwd_ref(x, w, rstd, g)
    assert dx.dtype == torch.bfloat16
    assert torch.equal(dw, (g.float() * t.float()).sum(0))


def test_one_rank_mesh_runs_the_wrapper_on_local_rows(monkeypatch):
    """A one-rank (data, model) mesh of fake DTensors (the dry run's
    world): the norm runs the kernels' wrapper on each rank's own rows, a
    plain tensor with the last dim whole, forward and again in the
    backward, and so their operators; y and the gradients come back as
    DTensors of the inputs' shapes."""
    from repro_torch.compat import DTensor, Replicate, make_mesh
    from repro_torch.launch.dryrun import fake_world

    calls = []
    real = L.rmsnorm_kernel
    monkeypatch.setattr(L, "rmsnorm_kernel",
                        lambda a, b, eps: calls.append((type(a).__name__, tuple(a.shape)))
                        or real(a, b, eps))
    with fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        rep = [Replicate(), Replicate()]
        with FakeTensorMode():
            x = torch.empty((2, 6, 64), dtype=torch.bfloat16)
            w = torch.empty(64)
            xd, wd = (DTensor.from_local(t, mesh, rep, run_check=False).requires_grad_()
                      for t in (x, w))
            y = L.rmsnorm(xd, wd, EPS)
            y.backward(torch.ones_like(y))
    assert calls == [("FakeTensor", (2, 6, 64))] * 2  # the local rows, not a DTensor
    assert isinstance(y, DTensor) and y.shape == xd.shape and y.dtype == torch.bfloat16
    assert isinstance(xd.grad, DTensor) and xd.grad.shape == xd.shape
    assert isinstance(wd.grad, DTensor) and wd.grad.dtype == torch.float32


def test_cpu_dtensors_take_the_eager_op(tmp_path):
    """Real CPU DTensors on a one-rank gloo mesh run the wrapper on their
    local rows, which on the CPU is the plain version: y, dx and dw equal
    the plain tensors' bit for bit."""
    from repro_torch.compat import Replicate, distribute_tensor, make_mesh

    if dist.is_initialized():
        pytest.skip("a process group is already running in this process")
    x, w, g = _draw((2, 6, 64), torch.bfloat16, seed=11)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        xd, wd, gd = (distribute_tensor(t, mesh, [Replicate(), Replicate()])
                      for t in (x, w, g))
        got = [t.full_tensor() for t in _grads(L.rmsnorm, xd, wd, gd)]
    finally:
        dist.destroy_process_group()
    for a, b in zip(got, _grads(eager_rmsnorm, x, w, g)):
        assert torch.equal(a, b)


def test_backward_source_holds_no_atomics():
    """dw is summed in a fixed order (per-CTA partials, then a second
    kernel), so reruns are bit-equal: the source calls no atomic."""
    src = SRC.read_text()
    assert "__global__" in src and not re.search(r"atomic\w*\s*\(|\bred\.", src)


# --------------------------------------------------------------------------- #
# against the JAX package
# --------------------------------------------------------------------------- #


def _jax_rmsnorm(x, w, g):
    """The JAX package's ``rmsnorm`` and its ``jax.vjp`` on the same
    values, as numpy float32: t (the norm before the weight: ``rmsnorm``
    with w = 1); y and dx with w cast to x's type first, as the port's norm
    casts it; dw as the reference forms it, of ``rmsnorm(x, w)`` with w in
    float32 (in bf16 the product promotes to float32, so dw is the rows'
    float32 sum of g t, the kernel's dw; through a cast of w to bf16 JAX
    would sum it in bf16, 0.4-1.6% of the float64 gradient here)."""
    import jax
    import jax.numpy as jnp
    from repro.models.layers import rmsnorm as jax_rmsnorm

    dt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[x.dtype]
    xj, gj = (jnp.asarray(t.float().numpy()).astype(dt) for t in (x, g))
    wj = jnp.asarray(w.numpy())
    y, pull = jax.vjp(lambda a: jax_rmsnorm(a, wj.astype(dt), EPS), xj)
    (dx,) = pull(gj)
    _, pull_w = jax.vjp(lambda b: jax_rmsnorm(xj, b, EPS), wj)
    (dw,) = pull_w(gj.astype(jnp.float32))
    t = jax_rmsnorm(xj, jnp.ones_like(wj).astype(dt), EPS)
    return {k: np.array(v.astype(jnp.float32)) for k, v in
            (("t", t), ("y", y), ("dx", dx), ("dw", dw))}


def _against_jax(want, x, w, y, rstd, dx, dw, dw_limit=DW_LIMIT):
    """y, dx and dw of a forward and backward against JAX's answers
    ``want``: t within one bf16 ulp of JAX's t and y equal to JAX's y
    wherever t is; dx and dw within the file's RMS limits."""
    dtype = x.dtype
    wt, wy, wdx, wdw = (torch.from_numpy(want[k]).to(x.device) for k in ("t", "y", "dx", "dw"))
    t = (x.float() * rstd[..., None]).to(dtype).float()
    same = t == wt
    assert bool(((t - wt).abs() <= bf16_ulp(wt)).all())
    assert torch.equal(y.float()[same], wy[same])
    assert rms_ratio(dx, wdx) <= DX_LIMIT[dtype], rms_ratio(dx, wdx)
    assert rms_ratio(dw, wdw) <= dw_limit, rms_ratio(dw, wdw)


@pytest.mark.parametrize("shape", [(4, 4096, 896), (3, 37, 900)], ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_versions_match_jax(shape, dtype):
    """At qwen2's training microbatch and a ragged width: the kernels'
    arithmetic in plain PyTorch (``rmsnorm_fwd_ref`` / ``rmsnorm_bwd_ref``)
    and the model's CPU route (autograd through the eager op) against the
    JAX package's ``rmsnorm`` and ``jax.vjp``, which are in turn within the
    same limits of the float64 gradients."""
    x, w, g = _draw(shape, dtype, seed=sum(shape) + 2)
    want = _jax_rmsnorm(x, w, g)
    y, rstd = K.rmsnorm_fwd_ref(x, w, EPS)
    _against_jax(want, x, w, y, rstd, *K.rmsnorm_bwd_ref(x, w, rstd, g))
    # the eager op's dw is the gradient of w cast to x's type: in bf16 a
    # bf16 value, so within one bf16 rounding's limit
    cy, cdx, cdw = _grads(L.rmsnorm, x, w, g)
    _against_jax(want, x, w, cy, rstd, cdx, cdw, DW_LIMIT if dtype == torch.float32
                 else DX_LIMIT[torch.bfloat16])
    exact_dx, exact_dw = rmsnorm_bwd_exact(x, w, rstd, g, EPS)
    assert rms_ratio(torch.from_numpy(want["dx"]), exact_dx) <= DX_LIMIT[dtype]
    assert rms_ratio(torch.from_numpy(want["dw"]), exact_dw) <= DW_LIMIT


# the stored answers' cases: a microbatch's rows on the vector path, and
# decode's one row a sequence at a width on the scalar path in bf16
JAX_CASES = [((2, 4, 896), torch.float32), ((2, 4, 896), torch.bfloat16),
             ((3, 1, 900), torch.float32), ((3, 1, 900), torch.bfloat16)]


def _case_key(shape, dtype) -> str:
    return "x".join(map(str, shape)) + "_" + str(dtype).split(".")[-1]


def _lattice(shape, dtype, device="cpu"):
    """x, w and g from integer formulas (the same bits on every machine):
    x and g multiples of 1/32 and 1/64 below 4 and 2 in size, exact in
    bf16; w ``1 + k / 256`` for k in -20..20."""
    n, d = int(np.prod(shape)), shape[-1]
    i = np.arange(n, dtype=np.int64)
    x = ((i * 2654435761 + 12345) % 1000003 % 255 - 127).astype(np.float32) / 32
    g = ((i * 40503 + 777) % 999983 % 255 - 127).astype(np.float32) / 64
    w = 1 + ((np.arange(d) * 7919) % 41 - 20).astype(np.float32) / 256
    return (torch.from_numpy(x.reshape(shape)).to(device, dtype), torch.from_numpy(w).to(device),
            torch.from_numpy(g.reshape(shape)).to(device, dtype))


def write_jax_answers(path=JAX_ANSWERS) -> None:
    """Store JAX's answers on :data:`JAX_CASES` (run from ``tests/``:
    ``python -c "import test_torch_rmsnorm as t; t.write_jax_answers()"``)."""
    out = {}
    for shape, dtype in JAX_CASES:
        for k, v in _jax_rmsnorm(*_lattice(shape, dtype)).items():
            out[_case_key(shape, dtype) + "_" + k] = v
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)


def _stored(shape, dtype) -> dict:
    with np.load(JAX_ANSWERS) as f:
        return {k: f[_case_key(shape, dtype) + "_" + k] for k in ("t", "y", "dx", "dw")}


@pytest.mark.parametrize("shape,dtype", JAX_CASES, ids=str)
def test_stored_jax_answers_are_current(shape, dtype):
    """``tests/data/rmsnorm_jax.npz`` holds what the JAX package computes
    today, bit for bit, and the plain versions meet it."""
    x, w, g = _lattice(shape, dtype)
    want = _jax_rmsnorm(x, w, g)
    stored = _stored(shape, dtype)
    for k in want:
        assert np.array_equal(stored[k], want[k]), k
    y, rstd = K.rmsnorm_fwd_ref(x, w, EPS)
    _against_jax(stored, x, w, y, rstd, *K.rmsnorm_bwd_ref(x, w, rstd, g))


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


# [rows..., d]: qwen2's training microbatch, ragged widths and row counts,
# decode's one row a sequence, a width on the scalar path (900: rows of
# 1,800 bytes are not whole 16-byte vectors), the widest row
CARD_SHAPES = [(4, 4096, 896), (3, 7, 64), (2, 5, 900), (16, 1, 3072), (9, 1600),
               (5, 33, 1), (2, 3, K.D_MAX)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_forward_keeps_the_rounding_points(cuda_device, shape, dtype):
    """The forward's only difference from the eager op is its sum's order:
    y is, bit for bit, the eager op's rounding of the kernel's own r
    (t = x r rounded to x's type, then t w~ rounded); r is within 1e-6 of
    the plain version's (two float32 sums of d squares in different orders,
    a few ulps); so t is within one bf16 ulp of the plain version's
    everywhere, and y equals it wherever t does."""
    x, w, _ = _draw(shape, dtype, seed=sum(shape), device=cuda_device)
    y, rstd = torch.ops.repro_torch.rmsnorm_fwd(x, w, EPS)
    gaps = forward_gaps(x, w, EPS, y, rstd)
    assert gaps["own_rounding"] and gaps["same_where_t_same"], gaps
    assert gaps["rstd_rel"] <= 1e-6 and gaps["t_ulps"] <= 1, gaps
    assert torch.equal(y, K.rmsnorm(x, w, EPS))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_backward_against_float64(cuda_device, shape, dtype):
    """dx and dw within ``ref.DX_LIMIT`` / ``ref.DW_LIMIT`` RMS of the
    float64 gradients; at the training shape in bf16 no further from them
    than autograd through the eager op (which rounds g w~ and dw to
    bf16); reruns bit-equal."""
    x, w, g = _draw(shape, dtype, seed=sum(shape) + 1, device=cuda_device)
    _, rstd = torch.ops.repro_torch.rmsnorm_fwd(x, w, EPS)
    dx, dw = torch.ops.repro_torch.rmsnorm_bwd(x, w, rstd, g)
    assert (dx.dtype, dx.shape, dw.dtype, dw.shape) == (dtype, x.shape, torch.float32,
                                                        w.shape)
    want_dx, want_dw = rmsnorm_bwd_exact(x, w, rstd, g, EPS)
    assert rms_ratio(dx, want_dx) <= DX_LIMIT[dtype]
    assert rms_ratio(dw, want_dw) <= DW_LIMIT
    again = torch.ops.repro_torch.rmsnorm_bwd(x, w, rstd, g)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)
    if dtype == torch.bfloat16 and x.numel() >= 2 ** 20:
        _, e_dx, e_dw = _grads(eager_rmsnorm, x, w, g)
        assert rms_ratio(dx, want_dx) <= rms_ratio(e_dx, want_dx)
        assert rms_ratio(dw, want_dw) <= rms_ratio(e_dw, want_dw)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", JAX_CASES, ids=str)
def test_cuda_kernels_match_jax(cuda_device, shape, dtype):
    """The kernels' y, dx and dw against the JAX package's ``rmsnorm`` and
    ``jax.vjp`` on the same inputs (stored in ``tests/data/rmsnorm_jax.npz``,
    which a CPU test holds to JAX as it computes today), at the file's
    limits."""
    x, w, g = _lattice(shape, dtype, device=cuda_device)
    y, rstd = torch.ops.repro_torch.rmsnorm_fwd(x, w, EPS)
    dx, dw = torch.ops.repro_torch.rmsnorm_bwd(x, w, rstd, g)
    _against_jax(_stored(shape, dtype), x, w, y, rstd, dx, dw)


@pytest.mark.cuda
def test_cuda_reruns_are_bit_equal_through_autograd(cuda_device):
    """The node's forward and backward at the training shape, twice: y, dx
    and dw bit-equal."""
    x, w, g = _draw((4, 4096, 896), torch.bfloat16, seed=5, device=cuda_device)
    first = _grads(L.rmsnorm, x, w, g)
    second = _grads(L.rmsnorm, x, w, g)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.float16, 64), (torch.float64, 64),
                                     (torch.bfloat16, K.D_MAX + 1)])
def test_cuda_raises_on_what_the_kernel_does_not_take(cuda_device, dtype, d):
    """float16, float64 and a last dim above ``D_MAX`` raise; nothing falls
    back to the eager op."""
    x = torch.ones((2, d), dtype=dtype, device=cuda_device)
    w = torch.ones(d, device=cuda_device)
    with pytest.raises(ValueError, match="takes float32 or bfloat16"):
        K.rmsnorm(x, w, EPS)


@pytest.mark.cuda
def test_cuda_launch_count_advances_once_a_call(cuda_device):
    """One forward launch a call; a backward (its kernel and the partials'
    sum) counts once."""
    x, w, g = _draw((3, 5, 128), torch.bfloat16, seed=2, device=cuda_device)
    K.reset_launches()
    for n in (1, 2):
        _grads(L.rmsnorm, x, w, g)
        assert K.LAUNCHES == {"rmsnorm_fwd": n, "rmsnorm_bwd": n}
    with torch.no_grad():
        L.rmsnorm(x, w, EPS)
    assert K.LAUNCHES == {"rmsnorm_fwd": 3, "rmsnorm_bwd": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_train_microbatch_norms_all_take_the_kernels(cuda_device, dtype,
                                                          monkeypatch):
    """A qwen2-shaped smoke model's loss and backward under remat on the
    card, with the plain versions made to raise: the forward kernel runs
    (2 a block, twice under remat) + 1 (the final norm) times, the backward
    2 a block + 1."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.models.model import Model

    def plain(*a, **k):
        raise AssertionError("the plain RMSNorm ran on the card")

    monkeypatch.setattr(ops, "rmsnorm_ref", plain)
    cfg = replace(smoke_config("qwen2-0.5b"), remat=True, dtype=dtype)
    model = Model.init(cfg, 0, cuda_device, getattr(torch, dtype))
    tokens = torch.randint(0, cfg.vocab, (2, 64), device=cuda_device,
                           generator=torch.Generator(cuda_device).manual_seed(0))
    K.reset_launches()
    loss = model.loss_fn({"tokens": tokens, "labels": tokens})
    loss.backward()
    n = cfg.n_layers
    assert K.LAUNCHES == {"rmsnorm_fwd": 2 * 2 * n + 1, "rmsnorm_bwd": 2 * n + 1}
    assert torch.isfinite(loss) and all(torch.isfinite(p.grad).all()
                                        for p in model.parameters())


@pytest.mark.parametrize("name,argtypes", [("rmsnorm_fwd_launch", "_FWD_ARGS"),
                                           ("rmsnorm_bwd_launch", "_BWD_ARGS")])
def test_launchers_match_the_wrapper(name, argtypes):
    """Each C launcher has as many parameters as its wrapper declares."""
    from repro_torch.kernels.rmsnorm import ops

    src = SRC.read_text()
    launcher = src[src.index(f'extern "C" int {name}('):]
    params = launcher[launcher.index("(") + 1:launcher.index(")")]
    assert len(params.split(",")) == len(getattr(ops, argtypes))
    assert re.search(r"kMaxD = (\d+);", src).group(1) == str(ops.D_MAX)
