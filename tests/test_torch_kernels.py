"""The port's ``pred_filter``, ``membership`` and ``flash_attention`` and
their entry points against the JAX package's, case by case as
``tests/test_kernels.py`` drives the reference.

The same numpy inputs, made from a seed, go through the reference's Pallas
kernels (interpret mode) and the port's wrappers on CPU tensors (their plain
PyTorch versions).  Masks must be exactly equal.  Attention agrees within
2e-5 in float32; in bf16 both sides compute in float32 from the same inputs
and round once, so they differ by rounding: within ``2**-7 * |want| +
1e-3``, one bf16 ulp of the value plus about 1% of a typical output
(median |out| 0.075-0.105 at these shapes, 0.026-0.029 at S = 4,096).
The CUDA kernel in bf16 also rounds P to bf16 before P V, so it is held to
``attention_limit`` per element and to ``BF16_RMS_LIMIT`` over all
elements; CPU tests emulate that rounding and check both, and check that a
control which also rounds the scores fails the second.
In float32 the CUDA kernel runs its products as split TF32; CPU tests
emulate that arithmetic (``attention_split_tf32``) within
``attention_limit``, check that one TF32 product exceeds it, hold it at
draws of std 2 and 3 against the float64 answer (``attention_exact``)
beside the plain float32 version, and check the row permutation of the
K-major copies the kernel's products read.
The cases that run a CUDA kernel against its plain version are skipped
without a card; the reference package is imported inside the parity
helpers, so those cases also run where JAX is not installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_kernels.py
"""

from __future__ import annotations

import inspect
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import expr as port_expr
from repro_torch.kernels.flash_attn import (
    BF16_RMS_LIMIT,
    LAUNCHES as FA_LAUNCHES,
    attention_bf16_scores,
    attention_exact,
    attention_limit,
    attention_lse_ref,
    attention_ref,
    attention_split_tf32,
    attention_tf32,
    flash_attention,
    flash_attention_fwd,
    kmajor_copy,
    mha_flash,
    mha_ref,
    rms_ratio,
)
from repro_torch.kernels.flash_attn.ref import KMAJOR_PERM, tf32
from repro_torch.kernels.flash_attn.ops import _fold
from repro_torch.kernels.membership import (
    LAUNCHES as MB_LAUNCHES,
    SENTINEL,
    membership,
    probe,
)
from repro_torch.kernels.membership.membership import (
    BLOCK_KEYS,
    FENCE_KEYS,
    SMEM_KEYS,
    fence_plan,
    launch_sorted,
)
from repro_torch.kernels.pred_filter import (
    LAUNCHES as PF_LAUNCHES,
    OPS,
    compile_conjunction,
    pred_filter,
    pred_filter_ref,
    scan_mask,
)

I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1


def _jnp():
    import jax.numpy as jnp

    return jnp


# --------------------------------------------------------------------------- #
# pred_filter (K3) and scan_mask
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n_rows", [512, 2048, 4096])
@pytest.mark.parametrize("n_atoms", [1, 3, 6])
def test_pred_filter_sweep(n_rows, n_atoms):
    from repro.kernels.pred_filter import pred_filter as ref_pred_filter

    jnp = _jnp()
    rng = np.random.default_rng(10 * n_rows + n_atoms)
    cols = rng.integers(-50, 50, (8, n_rows)).astype(np.int32)
    atoms = tuple((int(rng.integers(0, 8)), int(rng.integers(0, 6)))
                  for _ in range(n_atoms))
    thr = rng.integers(-50, 50, n_atoms).astype(np.int32)
    want = np.asarray(ref_pred_filter(jnp.asarray(cols), jnp.asarray(thr),
                                      atoms, block_rows=512, interpret=True))
    got = pred_filter(torch.from_numpy(cols), torch.from_numpy(thr), atoms,
                      block_rows=512)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        pred_filter_ref(torch.from_numpy(cols), torch.from_numpy(thr),
                        atoms).numpy(), want)


def test_pred_filter_rejects_unpadded_rows():
    cols = torch.zeros((2, 1000), dtype=torch.int32)
    with pytest.raises(ValueError):
        pred_filter(cols, torch.zeros(1, dtype=torch.int32), ((0, 0),),
                    block_rows=512)


def _predicates(E):
    """(name, predicate, binding) cases built from one package's ``expr``:
    kernel-compatible conjunctions first, then every None case."""
    Col, Lit, Param, BinOp = E.Col, E.Lit, E.Param, E.BinOp
    return [
        ("range_eq", E.land(Col("a") >= 10, Col("b") < 50,
                            Col("c").eq(Param("v"))), {"v": 7}),
        ("literal_left", E.land(BinOp("<", Lit(20), Col("a")),
                                BinOp(">=", Lit(60), Col("b")),
                                BinOp("!=", Lit(3), Col("c"))), {}),
        ("integral_float", E.land(Col("a") <= 40.0, Col("c").ne(Param("v"))),
         {"v": np.int64(5)}),
        ("single", Col("b") > Param("t"), {"t": 90}),
        ("not_binop", E.IsIn(Col("a"), (1, 2)), {}),
        ("not_comparison", E.land(Col("a") >= 1, Col("a") + 1), {}),
        ("fraction", E.land(Col("a") >= 1, Col("b") < 2.5), {}),
        ("bool", Col("a").eq(True), {}),
        ("list_value", Col("a").eq(Param("s")), {"s": [1, 2]}),
        ("array_value", Col("a").eq(Param("s")), {"s": np.array([1, 2])}),
        ("unbound_param", Col("a") < Param("missing"), {}),
        ("unknown_column", Col("z") < 3, {}),
        ("col_vs_col", Col("a") < Col("b"), {}),
        ("empty", E.land(), {}),
    ]


@pytest.mark.parametrize("case", [c[0] for c in _predicates(port_expr)])
def test_scan_mask_and_compile_match_reference(case):
    from repro.core import expr as ref_expr
    from repro.kernels.pred_filter import compile_conjunction as ref_compile
    from repro.kernels.pred_filter import scan_mask as ref_scan_mask

    (_, pred, binding), = [c for c in _predicates(port_expr) if c[0] == case]
    (_, rpred, rbinding), = [c for c in _predicates(ref_expr) if c[0] == case]
    rng = np.random.default_rng(sum(map(ord, case)))
    cols = rng.integers(0, 100, (3, 1000)).astype(np.int32)
    order = {"a": 0, "b": 1, "c": 2}

    got_c, want_c = (compile_conjunction(pred, order, binding),
                     ref_compile(rpred, order, rbinding))
    assert (got_c is None) == (want_c is None)
    if got_c is not None:
        assert got_c[0] == want_c[0]
        assert got_c[1].dtype == want_c[1].dtype == np.int32
        np.testing.assert_array_equal(got_c[1], want_c[1])

    want = ref_scan_mask(cols, rpred, order, rbinding, block_rows=512)
    for use_kernel in (True, False):
        got = scan_mask(cols, pred, order, binding, use_kernel=use_kernel,
                        block_rows=512, device="cpu")
        assert (got is None) == (want is None)
        if want is not None:
            assert got.dtype == want.dtype == np.bool_
            np.testing.assert_array_equal(got, want)
    if case == "range_eq":
        np.testing.assert_array_equal(
            want, (cols[0] >= 10) & (cols[1] < 50) & (cols[2] == 7))


# --------------------------------------------------------------------------- #
# membership (K4) and probe
# --------------------------------------------------------------------------- #


def _probe_all(vals, vset):
    """(port on the CPU, reference in interpret mode, np.isin)."""
    from repro.kernels.membership import probe as ref_probe

    got = probe(vals, vset, device="cpu")
    assert got.dtype == np.bool_ and got.shape == vals.shape
    return got, ref_probe(vals, vset, interpret=True), np.isin(vals, vset)


@pytest.mark.parametrize("n", [100, 1024, 5000])
@pytest.mark.parametrize("m", [1, 63, 256, 2000])
def test_probe_sweep(n, m):
    rng = np.random.default_rng(1000 * n + m)
    vals = rng.integers(0, 10_000, n).astype(np.int32)
    vset = rng.choice(10_000, m, replace=False).astype(np.int32)
    got, ref, want = _probe_all(vals, vset)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        probe(vals, vset, use_kernel=False, device="cpu"), want)


@pytest.mark.parametrize("case", ["large_set", "empty_set", "empty_values",
                                  "edge_keys"])
def test_probe_edges(case):
    rng = np.random.default_rng(len(case))
    if case == "large_set":  # past the reference's VMEM limit of 65,536 keys
        vset = rng.choice(1 << 22, 70_000, replace=False).astype(np.int32)
        vals = np.concatenate([rng.choice(vset, 1500),
                               rng.integers(0, 1 << 22, 1500)]).astype(np.int32)
    elif case == "empty_set":
        vals = rng.integers(0, 10, 100).astype(np.int32)
        vset = np.array([], np.int32)
    elif case == "empty_values":
        vals = np.array([], np.int32)
        vset = np.array([1, 2, 3], np.int32)
    else:  # the set holds the int32 extremes, so the reference's padding
        # with SENTINEL = INT32_MIN adds no member
        vset = np.array([I32_MIN, I32_MAX, -7, 0, 9, -7], np.int32)
        vals = np.array([I32_MIN, I32_MIN + 1, I32_MAX, I32_MAX - 1, -7, -8,
                         0, 9, 10] * 50, np.int32)
    got, ref, want = _probe_all(vals, vset)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)


def test_probe_sentinel_is_an_ordinary_value():
    """The port does not pad the set, so INT32_MIN is a member only when the
    set holds it, as in ``np.isin``.  (The reference pads the set with
    SENTINEL = INT32_MIN and reports INT32_MIN as a member here.)"""
    vals = np.array([SENTINEL, SENTINEL + 1, 5, I32_MAX], np.int32)
    vset = np.array([5, 7, I32_MAX], np.int32)
    np.testing.assert_array_equal(probe(vals, vset, device="cpu"),
                                  np.isin(vals, vset))


def test_membership_unsorted_duplicated_set():
    from repro.kernels.membership import membership as ref_membership

    jnp = _jnp()
    rng = np.random.default_rng(5)
    vset = rng.integers(-300, 300, 512).astype(np.int32)  # duplicates
    vals = rng.integers(-400, 400, 2048).astype(np.int32)
    got = membership(torch.from_numpy(vals), torch.from_numpy(vset))
    want = np.asarray(ref_membership(jnp.asarray(vals), jnp.asarray(vset),
                                     interpret=True))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.isin(vals, vset))
    with pytest.raises(ValueError):
        membership(torch.from_numpy(vals[:1000]), torch.from_numpy(vset))


def test_launch_sorted_takes_only_cuda_tensors():
    """``probe``'s route to the kernel never falls back to the plain
    version: CPU tensors raise."""
    from repro_torch.kernels.membership.membership import launch_sorted

    x = torch.arange(10, dtype=torch.int32)
    with pytest.raises(ValueError):
        launch_sorted(x, x)


def _emulate_k4(values: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Numpy mirror of ``csrc/membership.cu``'s two-level search over the
    sorted ``keys``: the lower bound among the staged keys (the set itself,
    or the last key of every aligned ``step``-key range) by branch-free
    halving of one length for every value; with ranges, the halving of the
    range on each half's last key (reads past the set clamped) down to an
    aligned block of ``BLOCK_KEYS`` keys, which is compared whole."""
    m = keys.size
    f, step = fence_plan(m)
    if f == 0:
        return np.zeros(values.shape, bool)
    arr = keys.astype(np.int64)
    idx = np.arange(f) if step == 1 else np.minimum((np.arange(f) + 1) * step, m) - 1
    fence = arr[idx]
    key = values.astype(np.int64)
    b = np.zeros(key.shape, np.int64)
    length = f
    while length > 1:
        half = length >> 1
        assert (b + half <= f - 1).all()  # level 1 reads need no clamp
        b = np.where(fence[b + half] < key, b + half, b)
        length -= half
    if step == 1:
        v0, v1 = fence[b], fence[np.minimum(b + 1, f - 1)]
        return (v0 == key) | ((b + 1 < f) & (v0 < key) & (v1 == key))
    b = (b + (fence[b] < key)) * step
    length = step
    while length > BLOCK_KEYS:
        half = length >> 1
        b = np.where(arr[np.minimum(b + half - 1, m - 1)] < key, b + half, b)
        length = half
    assert (b % BLOCK_KEYS == 0).all()
    hit = np.zeros(key.shape, bool)
    for j in range(BLOCK_KEYS):  # the block, keys past the set excluded
        hit |= (b + j < m) & (arr[np.minimum(b + j, m - 1)] == key)
    return hit


# set sizes around the staging limits: whole set in shared memory up to
# SMEM_KEYS keys; past it, fence counts around FENCE_KEYS (131,071 / 131,072
# / 131,073 keys: one key short of, at and one past FENCE_KEYS ranges of 8
# keys, the last range then partial, full, and 16 keys a range); 2^16 and
# q3's 729,395 order keys
K4_SIZES = [0, 1, 2, SMEM_KEYS - 1, SMEM_KEYS, SMEM_KEYS + 1, 1 << 16,
            8 * FENCE_KEYS - 1, 8 * FENCE_KEYS, 8 * FENCE_KEYS + 1, 729_395]


def _k4_case(m: int, order: str, n: int, seed: int):
    """A sorted set of ``m`` keys (duplicated when ``order`` says so) with
    the int32 extremes, and ``n`` values: sorted and grouped like
    ``l_orderkey``, or in random order; half of them members."""
    rng = np.random.default_rng(seed)
    if order == "duplicated":
        keys = np.sort(rng.integers(-(m // 2), m // 2 + 1, m))
    else:
        keys = np.sort(rng.choice(np.arange(-2 * m - 8, 2 * m + 8, 2), m,
                                  replace=False))
    keys = keys.astype(np.int64)
    if m >= 2:
        keys[0], keys[-1] = I32_MIN, I32_MAX
    keys = keys.astype(np.int32)
    hits = rng.choice(keys, n // 2) if m else np.zeros(n // 2, np.int32)
    near = rng.integers(-2 * m - 10, 2 * m + 10, n - n // 2)
    vals = np.concatenate([hits, near]).astype(np.int32)
    vals[:4] = [I32_MIN, I32_MAX, I32_MIN + 1, I32_MAX - 1]
    if order == "random":
        vals = rng.permutation(vals)
    else:  # grouped: each value repeated as an order's line items are
        vals = np.sort(vals)
    return vals, keys


def test_membership_constants_match_kernel_source():
    src = (Path(inspect.getfile(fence_plan)).parent / "csrc"
           / "membership.cu").read_text()
    assert f"constexpr int kSmemKeys = {SMEM_KEYS};" in src
    assert f"constexpr int kFenceKeys = {FENCE_KEYS};" in src
    assert f"constexpr int kBlockKeys = {BLOCK_KEYS};" in src
    assert fence_plan(SMEM_KEYS) == (SMEM_KEYS, 1)
    assert fence_plan(SMEM_KEYS + 1)[1] == BLOCK_KEYS
    assert fence_plan(8 * FENCE_KEYS) == (FENCE_KEYS, 8)
    assert fence_plan(8 * FENCE_KEYS + 1) == (FENCE_KEYS // 2 + 1, 16)
    assert fence_plan(729_395) == (11_397, 64)


@pytest.mark.parametrize("order", ["sorted", "random", "duplicated"])
@pytest.mark.parametrize("m", K4_SIZES)
def test_k4_two_level_search_equals_isin(m, order):
    vals, keys = _k4_case(m, order, 20_000, seed=m + len(order))
    np.testing.assert_array_equal(_emulate_k4(vals, keys), np.isin(vals, keys))


# --------------------------------------------------------------------------- #
# flash attention (K5) and mha_flash
# --------------------------------------------------------------------------- #

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2 ** -7, atol=1e-3)}


def _as_both(x: np.ndarray, dtype: str):
    jnp = _jnp()
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,d,window", [(256, 64, None), (512, 128, None),
                                        (384, 64, 128), (256, 32, None),
                                        (384, 32, 128), (256, 96, None),
                                        (384, 96, 128)])
def test_flash_attention_sweep(s, d, window, dtype):
    from repro.kernels.flash_attn import flash_attention as ref_flash

    rng = np.random.default_rng(s + d)
    q, k, v = (_as_both(rng.standard_normal((2, s, d)).astype(np.float32),
                        dtype) for _ in range(3))
    want = ref_flash(q[0], k[0], v[0], window=window, bq=128, bk=128,
                     interpret=True)
    got = flash_attention(q[1], k[1], v[1], window=window)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (2, s, d)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("window", [None, 64])
def test_mha_flash_layout(window):
    from repro.kernels.flash_attn import mha_flash as ref_mha_flash

    rng = np.random.default_rng(11)
    B, S, H, D = 2, 256, 4, 64
    q, k, v = (_as_both(rng.standard_normal((B, S, H, D)).astype(np.float32),
                        "float32") for _ in range(3))
    want = np.asarray(ref_mha_flash(q[0], k[0], v[0], window=window,
                                    interpret=True))
    got = mha_flash(q[1], k[1], v[1], window=window)
    assert tuple(got.shape) == (B, S, H, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(mha_ref(q[1], k[1], v[1], window=window).numpy(),
                               want, rtol=2e-5, atol=2e-5)


# the shapes the bf16 limit is checked at, on the CPU and on the card: every
# head dim the kernel is built for, S ragged against the kernel's 128-row
# tiles (288) or not, and windows narrower than a tile, so that rows meet
# fully masked tiles first
LIMIT_SHAPES = [(s, d, w) for d in (32, 64, 96, 128)
                for s in (64, 288, 384, 1024) for w in (None, 40, 100)]


def _bf16_inputs(seed: int, s: int, d: int, bh: int = 2):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((bh, s, d)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))


def _emulate_bf16_kernel(q, k, v, window):
    """The bf16 CUDA kernel's arithmetic in plain PyTorch: float32 scores
    and online softmax over its key tiles (128 keys, 64 above D = 64), P
    rounded to bf16 before P V, l summed from the float32 P, the output
    rounded to bf16 once."""
    BH, S, D = q.shape
    tile = 128 if D <= 64 else 64
    qf, kf, vf = q.float(), k.float(), v.float()
    pos = torch.arange(S)
    m = torch.full((BH, S, 1), -1e30)
    l = torch.zeros((BH, S, 1))
    acc = torch.zeros((BH, S, D))
    for k0 in range(0, S, tile):
        sc = torch.einsum("bqd,bkd->bqk", qf, kf[:, k0:k0 + tile]) / math.sqrt(D)
        kpos = pos[None, k0:k0 + tile]
        keep = kpos <= pos[:, None]
        if window is not None:
            keep &= kpos > pos[:, None] - window
        sc = sc.masked_fill(~keep, -1e30)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bqk,bkd->bqd", p.to(torch.bfloat16).float(),
                                         vf[:, k0:k0 + tile])
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(torch.bfloat16)


@pytest.mark.parametrize("s,d,window", LIMIT_SHAPES)
def test_bf16_p_rounding_stays_within_limit(s, d, window):
    """P rounded to bf16 before P V stays within ``attention_limit``."""
    q, k, v = _bf16_inputs(s + d + (window or 0), s, d)
    want = attention_ref(q, k, v, window=window)
    got = _emulate_bf16_kernel(q, k, v, window)
    err = (got.float() - want.float()).abs()
    assert bool((err <= attention_limit(q, k, v, want, window=window)).all())


@pytest.mark.parametrize("s,d,window", LIMIT_SHAPES)
def test_bf16_rms_limit_passes_kernel_fails_control(s, d, window):
    """Over all elements, the kernel's rounding stays within
    ``BF16_RMS_LIMIT`` and the control that also rounds the scores to bf16
    does not."""
    q, k, v = _bf16_inputs(s + d + (window or 0), s, d)
    want = attention_ref(q, k, v, window=window)
    assert rms_ratio(_emulate_bf16_kernel(q, k, v, window), want) <= BF16_RMS_LIMIT
    control = attention_bf16_scores(q, k, v, window=window)
    assert rms_ratio(control, want) > BF16_RMS_LIMIT


def test_attention_limit_float32():
    """float32 inputs keep the true-float32 limit, 2e-5 + 2e-5 |want|."""
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 128, 64)).astype(
        np.float32)) for _ in range(3))
    want = attention_ref(q, k, v, window=40)
    torch.testing.assert_close(attention_limit(q, k, v, want, window=40),
                               2e-5 + 2e-5 * want.abs(), rtol=0, atol=0)


# the shapes of the split-TF32 readings: every head dim, S 64 and 1,024,
# windows none and 40
SPLIT_SHAPES = [(s, d, w) for d in (32, 64, 96, 128) for s in (64, 1024)
                for w in (None, 40)]
FA_SRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/flash_attn/csrc"


def _f32_inputs(seed: int, s: int, d: int, bh: int = 2):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((bh, s, d)).astype(np.float32))
            for _ in range(3)]


@pytest.mark.parametrize("s,d,window", SPLIT_SHAPES)
def test_split_tf32_stays_within_float32_limit(s, d, window):
    """Q K^T and P V as split TF32 (three TF32 products) stay within
    ``attention_limit``."""
    q, k, v = _f32_inputs(s + d + (window or 0), s, d)
    want = attention_ref(q, k, v, window=window)
    got = attention_split_tf32(q, k, v, window=window)
    err = (got - want).abs()
    assert bool((err <= attention_limit(q, k, v, want, window=window)).all())


@pytest.mark.parametrize("s,d,window", SPLIT_SHAPES)
def test_one_tf32_product_exceeds_float32_limit(s, d, window):
    """The control, one TF32 product for Q K^T and P V, exceeds
    ``attention_limit`` several times over: the limit tells the split
    from a single TF32 product."""
    q, k, v = _f32_inputs(s + d + (window or 0), s, d)
    want = attention_ref(q, k, v, window=window)
    share = (attention_tf32(q, k, v, window=window) - want).abs() / attention_limit(
        q, k, v, want, window=window)
    assert float(share.max()) > 4


def _share(got, want, lim) -> float:
    return float(((got.double() - want.double()).abs() / lim).max())


@pytest.mark.parametrize("std", [2.0, 3.0])
@pytest.mark.parametrize("s,d,window", SPLIT_SHAPES)
def test_split_tf32_against_float64(s, d, window, std):
    """At draws of std 2 and 3 the split stays within twice the plain
    float32 version's error against the float64 answer (``attention_exact``),
    and one TF32 product is 50 times over.  At std 2 both stay within
    ``attention_limit``; at std 3 the plain version's own rounding of the
    scores can exceed it."""
    q, k, v = (x * std for x in _f32_inputs(s + d + (window or 0), s, d))
    want, _ = attention_exact(q, k, v, window=window)
    lim = attention_limit(q, k, v, want.float(), window=window)
    plain = _share(attention_ref(q, k, v, window=window), want, lim)
    split = _share(attention_split_tf32(q, k, v, window=window), want, lim)
    assert split <= 2 * plain
    assert std > 2 or max(split, plain) <= 1
    assert _share(attention_tf32(q, k, v, window=window), want, lim) > 50 * plain


def test_tf32_rounding():
    """``tf32`` clears the low 13 mantissa bits, rounding to nearest with
    ties away from zero or truncating; x - tf32(x) is exact."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 4, 1 + ulp / 2, 1 + 3 * ulp / 4, -(1 + ulp / 2), 3.0])
    assert tf32(x).tolist() == [1.0, 1 + ulp, 1 + ulp, -(1 + ulp), 3.0]
    assert tf32(x, "trunc").tolist() == [1.0, 1.0, 1.0, -1.0, 3.0]
    y = torch.from_numpy(np.random.default_rng(5).standard_normal(1000).astype(np.float32))
    for mode in ("rna", "trunc"):
        hi = tf32(y, mode)
        assert not bool((hi.view(torch.int32) & 0x1FFF).any())
        assert torch.equal((y - hi).double() + hi.double(), y.double())
    with pytest.raises(ValueError):
        tf32(y, "rne")


@pytest.mark.parametrize("s", [8, 64, 129, 200, 1024])
def test_kmajor_permutation_keeps_the_product(s):
    """A wgmma accumulator's thread holds columns 2c and 2c + 1 of each
    8-column block, which the kernel hands on (``split_a``: elements 0, 2,
    1, 3) as the TF32 A fragment's columns c and c + 4.  Read so, P times
    the permuted K-major copy is P V, and the copy is zero past S."""
    perm = [0] * 8
    for c in range(4):  # lane % 4
        perm[c], perm[c + 4] = 2 * c, 2 * c + 1
    assert tuple(perm) == KMAJOR_PERM
    rng = np.random.default_rng(s)
    p = torch.from_numpy(rng.random((64, s)))
    v = torch.from_numpy(rng.standard_normal((1, s, 32)))
    vt = kmajor_copy(v)
    s8 = -(-s // 8) * 8
    assert tuple(vt.shape) == (1, 32, s8) and not bool(vt[..., s:].any())
    # the A operand as the tensor cores read it: column 8g + i is the
    # accumulator's column 8g + perm[i]
    padded = torch.zeros((64, s8), dtype=p.dtype)
    padded[:, :s] = p
    seen = padded[:, torch.arange(s8).view(-1, 8)[:, perm].reshape(-1)]
    torch.testing.assert_close(seen @ vt[0].T, p @ v[0], rtol=1e-12, atol=1e-12)


def test_kmajor_permutation_matches_kernel_source():
    """The CUDA copy's source row and ``split_a``'s element order are the
    permutation the plain version and the test above use."""
    src = (FA_SRC / "split_tf32.cuh").read_text()
    expr = re.search(r"const int src = ([^;]+);", src).group(1)
    assert tuple(eval(expr, {"tx": i}) for i in range(8)) == KMAJOR_PERM
    assert "{x[4 * j], x[4 * j + 2], x[4 * j + 1], x[4 * j + 3]}" in src


def test_kmajor_scratch_is_taken_for_float32_only():
    """A float32 call takes ``copies`` K-major copies ``[BH, D, S8]`` of
    scratch from PyTorch's allocator; bf16 reads its operands as they lie."""
    from repro_torch.kernels.flash_attn.flash_attn import _kmajor_scratch

    x = torch.zeros((2, 129, 64))
    got = _kmajor_scratch(x, 3)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 2, 64, 136)
    assert _kmajor_scratch(x.to(torch.bfloat16), 3) is None


@pytest.mark.parametrize("path,name,params", [
    ("flash_attn.cu", "flash_attention_f32_smem", "int d"),
    ("flash_attn_bwd.cu", "flash_attention_bwd_f32_smem", "int d, int dq_pass")])
def test_float32_smem_entry_points(path, name, params):
    """``chip_smoke.py`` reads the float32 kernels' dynamic shared memory
    through these entry points, which answer every head dim the launchers
    take and -1 for others."""
    from repro_torch.kernels.flash_attn.flash_attn import HEAD_DIMS

    src = (FA_SRC / path).read_text()
    fn = src[src.index(f'extern "C" int {name}('):]
    fn = fn[:fn.index("\n}\n")]
    assert fn[fn.index("(") + 1:fn.index(")")] == params
    assert tuple(map(int, re.findall(r"case (\d+):", fn))) == HEAD_DIMS
    assert "default: return -1;" in fn


def test_bf16_forward_smem_entry_point():
    """``chip_smoke.py`` reads the bf16 forward's dynamic shared memory
    through ``flash_attention_bf16_smem(int d)``, which answers every head
    dim the launcher takes and -1 for others."""
    from repro_torch.kernels.flash_attn.flash_attn import HEAD_DIMS

    src = (FA_SRC / "flash_attn.cu").read_text()
    fn = src[src.index('extern "C" int flash_attention_bf16_smem('):]
    fn = fn[:fn.index("\n}\n")]
    assert fn[fn.index("(") + 1:fn.index(")")] == "int d"
    assert tuple(map(int, re.findall(r"case (\d+):", fn))) == HEAD_DIMS
    assert "default: return -1;" in fn


def _code(path: Path) -> str:
    """A CUDA source without its comments."""
    text = re.sub(r"/\*.*?\*/", "", path.read_text(), flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


@pytest.mark.parametrize("instruction", [r"mma\.sync", r"ldmatrix", r"cp\.async(?!\.bulk)"])
def test_k5_sources_hold_no_ampere_instructions(instruction):
    """Every K5 kernel runs on wgmma fed by TMA: no source or header under
    ``kernels/flash_attn/csrc`` issues ``mma.sync``, ``ldmatrix`` or a
    ``cp.async`` copy (TMA's ``cp.async.bulk`` is not one)."""
    paths = sorted(FA_SRC.glob("*.cu")) + sorted(FA_SRC.glob("*.cuh"))
    assert {p.name for p in paths} >= {"flash_attn.cu", "flash_attn_bwd.cu", "hopper.cuh"}
    assert "cp.async.bulk.tensor" in _code(FA_SRC / "hopper.cuh")  # the pattern's exception
    found = [p.name for p in paths if re.search(instruction, _code(p))]
    assert found == []


def test_head_dims_match_kernel_source():
    """The wrapper's head dims are the C launcher's guard and dispatch."""
    from repro_torch.kernels.flash_attn.flash_attn import HEAD_DIMS

    src = (Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/"
           "flash_attn/csrc/flash_attn.cu").read_text()
    launcher = src[src.index('extern "C" int flash_attention_launch'):]
    guard = launcher[:launcher.index("cudaErrorInvalidValue")]
    assert tuple(map(int, re.findall(r"d != (\d+)", guard))) == HEAD_DIMS
    cases = re.findall(r"case (\d+): return launch<(\d+)>", launcher)
    assert all(a == b for a, b in cases)
    default = re.findall(r"default: return launch<(\d+)>", launcher)
    assert tuple(int(a) for a, _ in cases) + tuple(map(int, default)) == HEAD_DIMS


def test_flash_attention_rejects_unpadded_seq():
    x = torch.zeros((1, 200, 64))
    with pytest.raises(ValueError):
        flash_attention(x, x, x)
    y = torch.zeros((1, 256, 64))
    with pytest.raises(ValueError):  # k, v of another shape than q
        flash_attention(y, x, x)
    with pytest.raises(ValueError):
        flash_attention(y, y, y, window=0)


# --------------------------------------------------------------------------- #
# the CUDA kernels against their plain versions (need a card)
# --------------------------------------------------------------------------- #


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_pred_filter_matches_plain(cuda_device):
    """Every op, a program of 9 atoms, and N = 1024 * 37 rows."""
    rng = np.random.default_rng(800)
    n = 1024 * 37
    cols = rng.integers(-40, 40, (4, n)).astype(np.int32)
    programs = [tuple((j % 4, op) for j, op in enumerate(ops))
                for ops in ((5, 2, 1), (0, 4, 3), (3, 1, 0, 5, 2, 4, 0, 1, 3))]
    for atoms in programs:
        thr = rng.integers(-40, 40, len(atoms)).astype(np.int32)
        thr[0] = cols[atoms[0][0], n // 2]  # an exact hit
        want = pred_filter(torch.from_numpy(cols), torch.from_numpy(thr), atoms)
        before = PF_LAUNCHES["single"]
        got = pred_filter(torch.from_numpy(cols).to(cuda_device),
                          torch.from_numpy(thr).to(cuda_device), atoms)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32
        assert torch.equal(got.cpu(), want), atoms
        assert PF_LAUNCHES["single"] == before + 1


@pytest.mark.cuda
def test_cuda_membership_matches_plain(cuda_device):
    """Edge keys, duplicates, an unsorted set, an empty set, and a set far
    past the reference's VMEM limit."""
    rng = np.random.default_rng(801)
    n = 1024 * 40
    vals = rng.integers(-5000, 5000, n).astype(np.int32)
    vals[:6] = [I32_MIN, I32_MIN + 1, I32_MAX, I32_MAX - 1, 0, -1]
    sets = [rng.integers(-5000, 5000, 777).astype(np.int32),
            np.array([I32_MIN, I32_MAX, 0], np.int32),
            np.array([], np.int32),
            rng.choice(1 << 24, 200_000, replace=False).astype(np.int32) - 5000]
    for vset in sets:
        want = membership(torch.from_numpy(vals), torch.from_numpy(vset))
        before = MB_LAUNCHES["membership"]
        got = membership(torch.from_numpy(vals).to(cuda_device),
                         torch.from_numpy(vset).to(cuda_device))
        torch.cuda.synchronize()
        assert got.dtype == torch.int32
        assert torch.equal(got.cpu(), want), vset.size
        assert MB_LAUNCHES["membership"] == before + 1
        got_probe = probe(vals[:1000], vset)
        np.testing.assert_array_equal(got_probe, np.isin(vals[:1000], vset))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_matches_plain(cuda_device, dtype, monkeypatch):
    """Every head dim, with and without a window, and an S that is not a
    multiple of the kernel's 128-row tile (bq = bk = 32 on the call)."""
    # the plain version's float32 products stay in float32 (no TF32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rng = np.random.default_rng(802)
    for s, d, window in ((256, 64, None), (384, 128, None), (512, 64, 100),
                         (288, 128, 40), (256, 32, None), (288, 32, 40),
                         (384, 96, None), (512, 96, 100)):
        q, k, v = (torch.from_numpy(rng.standard_normal((3, s, d)).astype(
            np.float32)).to(cuda_device, getattr(torch, dtype))
            for _ in range(3))
        want = attention_ref(q, k, v, window=window)
        before = FA_LAUNCHES["flash_attention"]
        got = flash_attention(q, k, v, window=window, bq=32, bk=32)
        torch.cuda.synchronize()
        assert got.dtype == q.dtype
        assert FA_LAUNCHES["flash_attention"] == before + 1
        err = (got.float() - want.float()).abs()
        assert bool((err <= attention_limit(q, k, v, want, window=window)).all())
    # the model layout at batch 1, where folding must still copy
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 256, 4, 64)).astype(
        np.float32)).to(cuda_device, getattr(torch, dtype)) for _ in range(3))
    got, want = mha_flash(q, k, v), mha_ref(q, k, v)
    err = (got.float() - want.float()).abs()
    assert bool((_fold(err) <= attention_limit(*map(_fold, (q, k, v, want)))).all())


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,d,window", [
    (3, 129, 64, None), (3, 200, 128, 128), (3, 129, 32, 2048), (3, 200, 96, 128),
    (2, 1024, 128, 128), (2, 4096, 64, 2048), (28, 4096, 64, None)])
def test_cuda_flash_attention_float32_edges(cuda_device, bh, s, d, window, monkeypatch):
    """The split-TF32 kernel at ragged S (129, 200: tiles past S), windows
    of 128 and 2,048 and qwen2-0.5b's training shape (BH 28, S 4,096, D
    64), element by element within ``attention_limit``, one launch."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v = (x.to(cuda_device) for x in _f32_inputs(s + d + bh, s, d, bh=bh))
    want = attention_ref(q, k, v, window=window)
    before = FA_LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, window=window, bq=1, bk=1)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert FA_LAUNCHES["flash_attention"] == before + 1
    err = (got - want).abs()
    assert bool((err <= attention_limit(q, k, v, want, window=window)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("std", [2.0, 3.0])
@pytest.mark.parametrize("bh,s,d,window", [
    (2, 1024, 128, None), (3, 1024, 64, 40), (2, 200, 96, None), (4, 4096, 64, None)])
def test_cuda_flash_attention_float32_against_float64(cuda_device, bh, s, d, window,
                                                      std, monkeypatch):
    """The split-TF32 kernel at draws of std 2 and 3 against the float64
    answer (``attention_exact``): at std 2 within ``attention_limit``; at
    std 3, where the plain float32 version's own rounding of the scores can
    exceed that limit, within twice the plain float32 version's error."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v = (x.to(cuda_device) * std for x in _f32_inputs(s + d + bh, s, d, bh=bh))
    want, _ = attention_exact(q, k, v, window=window)
    lim = attention_limit(q, k, v, want.float(), window=window)
    got = _share(flash_attention(q, k, v, window=window, bq=1, bk=1), want, lim)
    if std == 2.0:
        assert got <= 1
    else:
        assert got <= 2 * _share(attention_ref(q, k, v, window=window), want, lim)


@pytest.mark.cuda
@pytest.mark.parametrize("s,d,window", LIMIT_SHAPES)
def test_cuda_flash_attention_bf16_within_limit(cuda_device, s, d, window,
                                                monkeypatch):
    """The tensor-core kernel against the plain version, element by element
    within ``attention_limit``, and its launch counted once."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v = (x.to(cuda_device) for x in _bf16_inputs(s + d + (window or 0), s, d))
    want = attention_ref(q, k, v, window=window)
    before = FA_LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, window=window, bq=32, bk=32)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert FA_LAUNCHES["flash_attention"] == before + 1
    err = (got.float() - want.float()).abs()
    assert bool((err <= attention_limit(q, k, v, want, window=window)).all())
    assert rms_ratio(got, want) <= BF16_RMS_LIMIT


def _check_bf16_fwd(q, k, v, window):
    """``flash_attention_fwd`` (o in float32, the log-sum-exp) on bf16
    CUDA inputs against the plain version: o element by element within
    ``attention_limit`` and over all elements within ``BF16_RMS_LIMIT``,
    lse within 2e-5 (1 + |lse|); one launch."""
    before = FA_LAUNCHES["flash_attention"]
    o, lse = flash_attention_fwd(q, k, v, window=window, bq=1, bk=1)
    torch.cuda.synchronize()
    assert FA_LAUNCHES["flash_attention"] == before + 1
    assert o.dtype == torch.float32 and o.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:2]
    want = attention_ref(q.float(), k.float(), v.float(), window=window)
    assert bool(((o - want).abs() <= attention_limit(q, k, v, want, window=window)).all())
    assert rms_ratio(o, want) <= BF16_RMS_LIMIT
    want_lse = attention_lse_ref(q, k, v, window=window)
    assert bool(((lse - want_lse).abs() <= 2e-5 * (1 + want_lse.abs())).all())


def _check_bf16_prefill(q, k, v, window):
    """``flash_attention`` (o in bf16, no log-sum-exp) on bf16 CUDA inputs
    within ``attention_limit`` and ``BF16_RMS_LIMIT``; one launch."""
    before = FA_LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, window=window, bq=1, bk=1)
    torch.cuda.synchronize()
    assert FA_LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = attention_ref(q, k, v, window=window)
    assert bool(((got.float() - want.float()).abs()
                 <= attention_limit(q, k, v, want, window=window)).all())
    assert rms_ratio(got, want) <= BF16_RMS_LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("s,d,window", LIMIT_SHAPES)
def test_cuda_flash_attention_bf16_lse_within_limit(cuda_device, s, d, window,
                                                    monkeypatch):
    """The bf16 kernel's autograd mode (o in float32 and the log-sum-exp)
    at the limit shapes."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v = (x.to(cuda_device) for x in _bf16_inputs(s + d + (window or 0), s, d))
    _check_bf16_fwd(q, k, v, window)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,d,window", [
    (3, 129, 64, None), (3, 200, 128, 40), (3, 129, 32, 2048), (3, 200, 96, 128),
    (2, 4097, 64, None), (2, 4097, 128, 2048), (1, 4097, 96, None), (2, 4097, 32, 100)])
def test_cuda_flash_attention_bf16_ragged_s(cuda_device, bh, s, d, window, monkeypatch):
    """Both output modes of the bf16 kernel at S of 129, 200 and 4,097: the
    last query and key tiles run past S (zeros read, nothing written)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v = (x.to(cuda_device) for x in _bf16_inputs(s + d + bh, s, d, bh=bh))
    _check_bf16_prefill(q, k, v, window)
    _check_bf16_fwd(q, k, v, window)


@pytest.mark.cuda
def test_cuda_flash_attention_bf16_most_heads(cuda_device, monkeypatch):
    """BH of 65,535, the most the launcher takes (one grid column a head),
    in both output modes."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v = (x.to(cuda_device) for x in _bf16_inputs(65535, 96, 32, bh=65535))
    _check_bf16_prefill(q, k, v, 40)
    _check_bf16_fwd(q, k, v, None)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,d,window", [
    (2, 4096, 64, None), (3, 200, 96, 40), (2, 1024, 128, 2048), (4, 384, 32, None)])
def test_cuda_flash_attention_bf16_reruns_bit_equal(cuda_device, bh, s, d, window):
    """No atomics and a fixed order of sums: two calls on the same inputs
    give the same bits, in both output modes."""
    q, k, v = (x.to(cuda_device) for x in _bf16_inputs(s + d, s, d, bh=bh))
    first = flash_attention(q, k, v, window=window, bq=1, bk=1)
    assert torch.equal(first, flash_attention(q, k, v, window=window, bq=1, bk=1))
    o, lse = flash_attention_fwd(q, k, v, window=window, bq=1, bk=1)
    o2, lse2 = flash_attention_fwd(q, k, v, window=window, bq=1, bk=1)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 48, 80, 256])
def test_cuda_flash_attention_rejects_other_head_dims(cuda_device, d, dtype):
    """A head dim the kernel is not built for raises on CUDA tensors, with
    no launch and no fallback to the plain version."""
    q = torch.zeros((2, 128, d), dtype=getattr(torch, dtype), device=cuda_device)
    before = FA_LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    assert FA_LAUNCHES["flash_attention"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["sorted", "random", "duplicated"])
@pytest.mark.parametrize("m", K4_SIZES)
def test_cuda_membership_staging_limits(cuda_device, m, order):
    """K4 through ``launch_sorted`` (the kernel as ``probe`` launches it)
    and ``membership`` (which sorts but keeps duplicates) equal to
    ``np.isin`` at set sizes around the shared-memory and fence limits, on
    grouped and random values, with ``n`` not a multiple of a CTA's 4,096
    values."""
    n = 8192 * 9 + 1000 + 5
    vals, keys = _k4_case(m, order, n, seed=2000 + m + len(order))
    want = np.isin(vals, keys)
    before = MB_LAUNCHES["membership"]
    got = launch_sorted(torch.from_numpy(vals).to(cuda_device),
                        torch.from_numpy(keys).to(cuda_device))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy().astype(bool), want)
    assert MB_LAUNCHES["membership"] == before + 1
    # a set that does not start on 16 bytes: launch_sorted copies a large one
    offset = torch.zeros(m + 1, dtype=torch.int32, device=cuda_device)
    offset[1:] = torch.from_numpy(keys)
    got = launch_sorted(torch.from_numpy(vals).to(cuda_device), offset[1:])
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy().astype(bool), want)
    n_pad = n - n % 1024
    shuffled = np.random.default_rng(m).permutation(keys)
    got = membership(torch.from_numpy(vals[:n_pad]).to(cuda_device),
                     torch.from_numpy(shuffled).to(cuda_device))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy().astype(bool), want[:n_pad])
