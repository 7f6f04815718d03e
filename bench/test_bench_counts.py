"""The frozen arithmetic: FLOP and byte counts against hand counts at the
cells' shapes, the trace reduction on synthetic spans, and each per-layer
reader on a synthetic record."""

import pytest

from benchlib import counts, spans
from benchlib.harness import Record
from benchlib.manifest import load
from benchtest import ROOT

MAN = load(ROOT)
QWEN = MAN.config("qwen2-0.5b")


def test_pairs():
    assert counts.attention_pairs(4) == 10
    assert counts.attention_pairs(4096) == 4096 * 4097 // 2
    assert counts.attention_pairs(5, window=2) == 3 + 3 * 2


def test_qwen2_train_step_flops_by_hand():
    # per layer: q 896x896, k and v 896x128 each, o 896x896, MLP 3 x 896x4864
    per_layer = 896 * 896 * 2 + 896 * 128 * 2 + 3 * 896 * 4864
    assert counts.block_matrix_entries(QWEN) == per_layer == 14_909_440
    n = 24 * per_layer + 896 * 151_936
    attn = 4 * 14 * 64 * (4096 * 4097 // 2) * 24 * 8
    assert counts.train_step_flops(QWEN, 8, 4096) == 6 * n * 8 * 4096 + 3 * attn
    assert counts.train_step_flops(QWEN, 8, 4096) == pytest.approx(1.1443e14, rel=1e-3)
    # train-1k: the same tokens, a quarter of the pairs per token
    assert counts.train_step_flops(QWEN, 32, 1024) == (
        6 * n * 32 * 1024 + 3 * 4 * 14 * 64 * (1024 * 1025 // 2) * 24 * 32)


def test_k5_roofline_hand_case():
    # qwen2's training microbatch: 2 sequences, 14 heads of 64, 2 KV heads
    ops, nbytes = counts.k5_forward(QWEN, 2, 4096, lse=True)
    assert ops == 4 * 64 * 2 * 14 * (4096 * 4097 // 2)
    q = 2 * 4096 * 14 * 64 * 2
    kv = 2 * 4096 * 2 * 64 * 2
    assert nbytes == 2 * q + 2 * kv + 2 * 14 * 4096 * 4
    t, which = counts.bound_s(ops, nbytes)
    assert which == "compute" and t == pytest.approx(60.81e-6, rel=1e-3)
    bops, bbytes = counts.k5_backward(QWEN, 2, 4096)
    assert bops == ops * 10 // 4
    assert bbytes == 4 * q + 4 * kv + 2 * 14 * 4096 * 4
    # a memory-bound case: one query position, no pairs to speak of
    t, which = counts.bound_s(*counts.k5_forward(QWEN, 1, 1, lse=False))
    assert which == "memory"


def test_busy_is_the_union_and_idle_the_rest():
    dev = [(10, 20, "a"), (15, 30, "b"), (40, 50, "c"), (0, 5, "before")]
    assert spans.busy_ns(dev, 10, 60) == 30
    assert spans.idle_gaps(dev, 10, 60) == [(30, 40), (50, 60)]
    assert spans.busy_ns([], 0, 100) == 0
    assert spans.idle_gaps([], 0, 100) == [(0, 100)]


def test_gaps_take_the_innermost_host_operator():
    host = [(0, 100, spans.WINDOW_RANGE), (0, 60, "aten::step"), (25, 38, "aten::item"),
            (44, 48, "cudaLaunchKernel")]
    gaps = [(30, 40), (45, 47), (70, 80)]
    assert spans.name_gaps(gaps, host) == {"aten::item": 10, "cudaLaunchKernel": 2,
                                           "host (no operator)": 10}


def test_names_match_by_prefix_and_word():
    fwd = spans.named("flash_attention")
    assert fwd("void flash_attention_bf16<64, float>(CUtensorMap, int)")
    # as the CUDA profiler names the port's kernels
    assert fwd("(anonymous namespace)::flash_attention_bf16<64, float>(CUtensorMap_st, int)")
    assert spans.named("flash_bwd")("void (anonymous namespace)::flash_bwd_dq_bf16<64>(x)")
    assert not fwd("void flash_bwd_dq_bf16<64>(CUtensorMap)")
    assert not fwd("at::native::elementwise_kernel<flash_attention>(int)")
    glue = spans.saying("elementwise", "reduce")
    assert glue("void at::native::vectorized_elementwise_kernel<4, ...>")
    assert glue("void at::native::reduce_kernel<512, 1, ...>")
    assert not glue("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN")


def _train_record(n_steps=2):
    L, A = QWEN["num_hidden_layers"], 4
    units = [{"kind": "train", "batch": 8, "seq": 4096, "microbatches": A,
              "start": 0.0, "end": 1.0} for _ in range(n_steps)]
    fwd_t, _ = counts.bound_s(*counts.k5_forward(QWEN, 2, 4096, True))
    bwd_t, _ = counts.bound_s(*counts.k5_backward(QWEN, 2, 4096))
    dev, t = [], 0
    for _ in range(n_steps):
        for _ in range(2 * L * A):  # each forward at twice its bound
            d = int(2 * fwd_t * 1e9)
            dev.append((t, t + d, "void flash_attention_bf16<64, float>(x)"))
            t += d
        for _ in range(L * A):  # each backward's three passes at 4x its bound
            d = int(4 * bwd_t * 1e9 / 3)
            for k in ("delta", "dkdv_bf16<64>", "dq_bf16<64>"):
                dev.append((t, t + d, f"void flash_bwd_{k}(x)"))
                t += d
        dev.append((t, t + 1_000_000, "void at::native::elementwise_kernel<x>"))
        t += 1_000_000
    hi = 2 * t
    prof = spans.Profile(dev, [(0, hi, spans.WINDOW_RANGE)], 0, hi, units)
    window = [dict(u, start=float(i), end=float(i + 1)) for i, u in enumerate(units)]
    return Record(QWEN, MAN.traffic("train-4k"), window, prof), dev, hi


def test_train_readers_on_a_synthetic_record():
    rec, dev, hi = _train_record()
    read = {m: MAN.reader(m).read(rec) for m in MAN.per_layer}
    assert read["k5_fwd_roofline_pct.train"] == pytest.approx(50.0, rel=1e-3)
    assert read["k5_bwd_roofline_pct.train"] == pytest.approx(25.0, rel=1e-3)
    assert read["elementwise_ms_per_step.train"] == pytest.approx(1.0)
    assert read["device_kernels_per_step.train"] == len(dev) / 2
    # busy a profiled step over the untraced window's second a step
    busy_s = spans.busy_ns(dev, 0, hi) * 1e-9 / 2
    assert read["device_idle_pct.train"] == pytest.approx(100 * (1 - busy_s / 1.0), rel=1e-9)
    flops = 2 * counts.train_step_flops(QWEN, 8, 4096)
    assert read["train_mfu_pct"] == pytest.approx(100 * flops / 2.0 / 989e12)


def test_readers_are_silent_without_the_device():
    rec, _, hi = _train_record()
    rec.profile.device = []
    for m in MAN.per_layer:
        if m != "train_mfu_pct":
            assert MAN.reader(m).read(rec) is None, m
    rec.profile = None
    assert MAN.reader("device_idle_pct.train").read(rec) is None


def test_roofline_is_silent_when_launches_do_not_match_the_shapes():
    rec, _, _ = _train_record()
    rec.profile.device = [s for s in rec.profile.device if "flash_attention" not in s[2]][:-1] \
        + [s for s in rec.profile.device if "flash_attention" in s[2]][1:]
    assert MAN.reader("k5_fwd_roofline_pct.train").read(rec) is None
