"""The port's spans in the benchmark (``benchlib/program_spans.py``) and
the tool that reads them (``tools/step_spans.py``), at test size on the
CPU: the split of a step from its spans, gaps and kernels named by the
innermost span, the tool's numbers on a tiny cell, and an untraced
benchmark run that records nothing."""

import importlib.util
import math
import time

import pytest

from benchlib import harness, manifest, program_spans as ps
from benchtest import BENCH, LOOSE, add_tiny_cells, copy_benchmark
from repro_torch import trace

SEED = 2**31 + 91
SIX = tuple(ps.PER_STEP) + (ps.BETWEEN,)
# a step's spans at 2 microbatches: the step, 2 forwards, 2 backwards, 2
# sums and the division, the optimizer, 2 heads
STEP_SPANS = 1 + 2 + 2 + 3 + 1 + 2


class Rec:
    """A span as ``repro_torch.trace`` records it, made by hand."""

    def __init__(self, name, host, device, id=0, parent=None, step=0):
        self.name, self.id, self.parent, self.step = name, id, parent, step
        self.host_start_ns, self.host_end_ns = host
        self.device_start_ms, self.device_end_ms = device

    @property
    def host_ms(self):
        return (self.host_end_ns - self.host_start_ns) * 1e-6

    @property
    def device_ms(self):
        return self.device_end_ms - self.device_start_ms


def two_steps():
    """Two steps of 10 device ms, 2 ms apart: forward 3 (head 1 of it),
    backward 4, grad_accum 1 + 0.5, optimizer 1, and 0.5 ms in the step
    outside every part."""
    out = []
    for t in (0.0, 12.0):
        out += [Rec("train.step", (0, 10), (t, t + 10)),
                Rec("train.forward", (0, 1), (t, t + 3)),
                Rec("model.head", (0, 1), (t + 2, t + 3)),
                Rec("train.backward", (0, 1), (t + 3, t + 7)),
                Rec("train.grad_accum", (0, 1), (t + 7, t + 8)),
                Rec("train.grad_accum", (0, 1), (t + 8, t + 8.5)),
                Rec("optim.update", (0, 1), (t + 9, t + 10))]
    return out


def test_the_split_of_two_steps():
    s = ps.split(two_steps())
    m = s["metrics"]
    assert s["steps"] == 2
    assert m == pytest.approx({"forward_ms_per_step.train": 3.0,
                               "backward_ms_per_step.train": 4.0,
                               "grad_accum_ms_per_step.train": 1.5,
                               "optimizer_ms_per_step.train": 1.0,
                               "head_fwd_ms_per_step.train": 1.0,
                               "between_steps_ms.train": 2.0})
    assert s["step_device_ms"] == pytest.approx(12.0)
    assert s["accounted_pct"] == pytest.approx(100.0 * 11.5 / 12.0)
    assert s["host_ms_per_step"]["train.step"] == pytest.approx(10e-6)
    assert "program spans over 2 steps" in ps.accounting_line(s)


def test_one_step_has_no_gap_between_steps_and_no_records_no_split():
    one = [r for r in two_steps() if r.device_start_ms < 11]
    assert ps.BETWEEN not in ps.split(one)["metrics"]
    assert ps.split([]) is None


def test_gaps_and_kernels_go_to_the_innermost_open_span():
    recs = [Rec("train.step", (100, 200), (0, 0)), Rec("train.forward", (110, 150), (0, 0)),
            Rec("model.head", (140, 150), (0, 0)), Rec("optim.update", (170, 190), (0, 0))]
    gaps = [(100, 120), (140, 146), (150, 170), (185, 195), (300, 310)]
    assert ps.gaps_by_span(gaps, recs) == {"train.forward": 20, "model.head": 6,
                                           "train.step": 20, "optim.update": 10,
                                           ps.NO_SPAN: 10}
    launches = [(111, 5), (145, 7), (160, 1), (50, 2)]
    assert ps.by_innermost_span(launches, recs) == {"train.forward": 5, "model.head": 7,
                                                  "train.step": 1, ps.NO_SPAN: 2}


@pytest.fixture()
def tiny_root(tmp_path):
    root = copy_benchmark(tmp_path)
    add_tiny_cells(root, LOOSE)
    return root


def load_tool():
    spec = importlib.util.spec_from_file_location("step_spans", BENCH / "tools" / "step_spans.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_tool_reports_the_six_numbers_on_a_tiny_cell(tiny_root):
    out = load_tool().measure(manifest.load(tiny_root), "tiny-lm.tiny-train", SEED, "cpu",
                              seconds=0.3, windows=1)
    assert out["rates"]["order"] == ["off", "on"]
    assert all(r > 0 for r in out["rates"]["off"] + out["rates"]["on"])
    assert out["rates"]["spans_a_step"][0] == STEP_SPANS
    for part in ("recorder_pass", "device_profile", "host_profile"):
        s = out[part] if part == "recorder_pass" else out[part]["split"]
        assert set(s["metrics"]) == set(SIX), part
        assert all(math.isfinite(v) and v >= 0 for v in s["metrics"].values()), part
        assert 0 < s["accounted_pct"] <= 100.0 + 1e-6, part
    assert out["host_profile"]["idle_gaps_by_span_ms_per_step"]
    assert not trace.take()  # the recorder was left off and empty


def test_an_untraced_benchmark_run_records_no_span(tiny_root):
    out = harness.run_cell(manifest.load(tiny_root), "tiny-lm.tiny-train", SEED, 0.3, False,
                           "cpu", time.perf_counter())
    assert out["correct"]
    assert set(out["metrics"]) == {"setup_s", "train_tokens_per_s"}
    assert trace.take() == []


def test_device_operations_are_sorted_by_kind():
    kind = load_tool().kind
    assert kind("void at::native::vectorized_elementwise_kernel<4, at::native::F>(int)") == \
        "elementwise"
    assert kind("void at::native::reduce_kernel<512, 1>(at::native::R)") == "elementwise"
    assert kind("nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN") == "gemm"
    assert kind("void flash_attention_bf16<64, float>(CUtensorMap_st)") == "k5"
    assert kind("void (anonymous namespace)::flash_bwd_dq<64>(int)") == "k5"
    assert kind("Memcpy HtoD (Pageable -> Device)") == "copy"
    assert kind("void at::native::cunn_SoftMaxForward<4, float>(float*)") == "other"


def test_elementwise_time_goes_to_the_innermost_named_host_operation():
    tool = load_tool()
    host = [(0, 100, tool.NODE + "LogsumexpBackward0"), (10, 20, "aten::exp"),
            (30, 40, "cudaLaunchKernel"), (200, 300, "aten::mul")]
    launches = [(15, 4_000_000, "elementwise"), (35, 2_000_000, "elementwise"),
                (35, 9_000_000, "gemm"), (250, 1_000_000, "elementwise")]
    assert tool.elementwise_by_host_op(launches, host, 2, tool.NODE) == {
        "LogsumexpBackward0": 3.0, ps.NO_SPAN: 0.5}
    assert tool.elementwise_by_host_op(launches, host, 1, "aten::") == {
        "aten::exp": 4.0, ps.NO_SPAN: 2.0, "aten::mul": 1.0}
