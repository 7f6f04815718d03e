"""``rmsnorm_ms_per_step.train`` on synthetic records: the kernels' device
time a step where their launches are the shapes' norm calls, nothing
where they are not (the parent's program has no such kernels)."""

import pytest

from benchlib import spans
from benchlib.harness import Record
from benchlib.manifest import load
from benchtest import ROOT

MAN = load(ROOT)
QWEN = MAN.config("qwen2-0.5b")
NAMES = {"fwd": "void (anonymous namespace)::rmsnorm_fwd<__nv_bfloat16, 8>(x)",
         "bwd": "void (anonymous namespace)::rmsnorm_bwd<__nv_bfloat16, 8>(x)",
         "dw": "void (anonymous namespace)::rmsnorm_dw(float const*, float*, int, int)"}


def _record(traffic="train-4k", steps=2, drop=None):
    """Each step's norm launches at 10 us (forward), 20 us (backward) and
    1 us (the partials' sum) beside one elementwise kernel; ``drop`` leaves
    one launch of that kind out."""
    tr = MAN.traffic(traffic)
    L, A = QWEN["num_hidden_layers"], tr["microbatches"]
    per = {"fwd": (((2 if tr["remat"] else 1) * 2 * L + 1) * A, 10_000),
           "bwd": ((2 * L + 1) * A, 20_000), "dw": ((2 * L + 1) * A, 1_000)}
    units = [{"kind": "train", "batch": tr["sequences"], "seq": tr["seq_len"],
              "microbatches": A, "start": float(i), "end": float(i + 1)}
             for i in range(steps)]
    dev, t = [], 0
    for _ in range(steps):
        for kind, (n, ns) in per.items():
            for _ in range(n):
                dev.append((t, t + ns, NAMES[kind]))
                t += ns
        dev.append((t, t + 5_000, "void at::native::elementwise_kernel<x>"))
        t += 5_000
    if drop:
        dev.remove(next(s for s in dev if s[2] == NAMES[drop]))
    prof = spans.Profile(dev, [(0, t, spans.WINDOW_RANGE)], 0, t, units)
    return Record(QWEN, tr, units, prof), per


@pytest.mark.parametrize("traffic", ["train-4k", "train-1k"])
def test_reads_the_norm_kernels_ms_a_step(traffic):
    rec, per = _record(traffic)
    want = sum(n * ns for n, ns in per.values()) * 1e-6
    assert MAN.reader("rmsnorm_ms_per_step.train").read(rec) == pytest.approx(want)
    # the norm's forward: (2 a layer, twice under remat) + 1, a microbatch
    assert per["fwd"][0] == 97 * 2 and per["bwd"][0] == per["dw"][0] == 49 * 2
    # the kernels are not counted as elementwise glue
    assert MAN.reader("elementwise_ms_per_step.train").read(rec) == pytest.approx(0.005)


@pytest.mark.parametrize("drop", ["fwd", "bwd", "dw"])
def test_silent_where_a_launch_count_is_not_the_shapes(drop):
    rec, _ = _record(drop=drop)
    assert MAN.reader("rmsnorm_ms_per_step.train").read(rec) is None


def test_silent_without_the_kernels():
    rec, _ = _record()
    rec.profile.device = [s for s in rec.profile.device if "rmsnorm" not in s[2]]
    assert MAN.reader("rmsnorm_ms_per_step.train").read(rec) is None
    rec.profile.device = []
    assert MAN.reader("rmsnorm_ms_per_step.train").read(rec) is None
