"""The port's span recorder (``repro_torch.trace``) and its spans in the
training step.

Off, the recorder records nothing, creates no CUDA event and leaves a
step's numbers bit-identical. On, a remat step at two microbatches
records its spans with their parents and one step id. A span's host
times lie on ``torch.profiler``'s own clock. The card cases (``-m cuda``,
skipped without a card) hold the device intervals on the card's stream:

    python -m pytest -q --noconftest -m cuda tests/test_torch_trace.py
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch import configs as port_configs
from repro_torch import trace
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import Model
from repro_torch.optim import adamw

STEP_SPANS = {"train.step": 1, "train.forward": 2, "train.backward": 2,
              "train.grad_accum": 3, "optim.update": 1, "model.head": 2}
PARENTS = {"train.step": None, "train.forward": "train.step",
           "train.backward": "train.step", "train.grad_accum": "train.step",
           "optim.update": "train.step", "model.head": "train.forward"}


@pytest.fixture(autouse=True)
def recorder_off():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


def device_of(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device(name)


DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def smoke(device, accum=2, remat=True):
    """A smoke qwen2 at ``accum`` microbatches, its optimizer state, its
    step and a batch of 4 sequences of 32 tokens."""
    cfg = replace(port_configs.smoke_config("qwen2-0.5b"), remat=remat, accum_steps=accum)
    model = Model.init(cfg, seed=0, device=device, dtype=torch.bfloat16)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0)
    opt = adamw.init(dict(model.named_parameters()), opt_cfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (4, 32)))
    toks = toks.to(device)
    return model, opt, make_train_step(cfg, opt_cfg), {"tokens": toks, "labels": toks}


def test_off_records_nothing_and_creates_no_event(monkeypatch):
    made = []

    def no_event(*a, **k):
        made.append(1)
        raise AssertionError("a CUDA event was created with the recorder off")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    assert trace.span("a") is trace.span("b")  # the one shared no-op object
    with trace.span("a") as s:
        assert s is None
    model, opt, step, b = smoke("cpu")
    step(model, opt, b)
    assert trace.take() == [] and made == []


def test_a_step_is_bit_identical_with_the_recorder_on_and_off():
    runs = []
    for on in (False, True):
        if on:
            trace.enable("cpu")
        model, opt, step, b = smoke("cpu")
        model, opt, m = step(model, opt, b)
        trace.disable()
        runs.append((m, {k: p.detach().clone() for k, p in model.named_parameters()}))
    (m0, w0), (m1, w1) = runs
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    assert w0.keys() == w1.keys()
    assert all(torch.equal(w0[k], w1[k]) for k in w0)
    assert len(trace.take()) == sum(STEP_SPANS.values())


def check_step_spans(spans):
    """One step's spans: the expected count of each name, each under its
    expected parent, all with the ``train.step`` span's id as their step,
    and each device interval inside its parent's."""
    assert Counter(s.name for s in spans) == STEP_SPANS
    by_id = {s.id: s for s in spans}
    root = next(s for s in spans if s.name == "train.step")
    for s in spans:
        assert s.step == root.id, s
        up = by_id.get(s.parent)
        assert (up.name if up else None) == PARENTS[s.name], s
        assert s.host_start_ns <= s.host_end_ns
        assert s.device_start_ms <= s.device_end_ms
        if up is not None:
            assert up.host_start_ns <= s.host_start_ns <= s.host_end_ns <= up.host_end_ns
            assert up.device_start_ms <= s.device_start_ms
            assert s.device_end_ms <= up.device_end_ms
    assert spans == sorted(spans, key=lambda s: s.host_start_ns)


@pytest.mark.parametrize("device", DEVICES)
def test_a_remat_step_at_two_microbatches_records_its_spans(device):
    dev = device_of(device)
    model, opt, step, b = smoke(dev)
    trace.enable(dev)
    step(model, opt, b)
    trace.disable()
    spans = trace.take()
    check_step_spans(spans)
    assert trace.take() == []
    # the forward spans of a step hold its head spans, one each
    fwd = [s for s in spans if s.name == "train.forward"]
    head = [s for s in spans if s.name == "model.head"]
    assert sorted(h.parent for h in head) == sorted(f.id for f in fwd)


def test_two_steps_get_two_step_ids():
    model, opt, step, b = smoke("cpu", accum=1, remat=False)
    trace.enable("cpu")
    model, opt, _ = step(model, opt, b)
    step(model, opt, b)
    spans = trace.take()
    roots = [s for s in spans if s.name == "train.step"]
    assert len(roots) == 2 and roots[0].id != roots[1].id
    assert {s.step for s in spans} == {r.id for r in roots}
    # at one microbatch there is no division, so one sum a step
    assert Counter(s.name for s in spans)["train.grad_accum"] == 2


def test_parents_are_the_innermost_span_of_the_same_thread():
    trace.enable("cpu")
    seen = {}

    def other():
        with trace.span("other") as s:
            seen["other"] = s

    with trace.span("outer") as outer:
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with trace.span("inner", part=1) as inner:
            pass
    assert inner.parent == outer.id and inner.step == outer.id
    assert inner.attrs == {"part": 1}
    assert seen["other"].parent is None and seen["other"].step == seen["other"].id
    assert {s.name for s in trace.take()} == {"outer", "inner", "other"}


def test_a_span_open_when_the_recorder_stops_still_records():
    trace.enable("cpu")
    with trace.span("a"):
        trace.disable()
        with trace.span("b") as b:
            assert b is None
    assert [s.name for s in trace.take()] == ["a"]


@pytest.mark.parametrize("device", DEVICES)
def test_span_host_times_lie_on_the_profilers_clock(device):
    """A span inside a ``record_function`` range lies inside it on the
    profiler's own timestamps, with a millisecond of margin on each side
    that the span may not cross; the recorder adds no range of its own."""
    from torch.profiler import ProfilerActivity, profile, record_function

    dev = device_of(device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    x = torch.randn(64, 64, device=dev)
    trace.enable(dev)
    with profile(activities=acts) as prof:
        with record_function("outer"):
            time.sleep(2e-3)
            with trace.span("inner"):
                x = x @ x
            time.sleep(2e-3)
    trace.disable()
    (s,) = trace.take()
    events = [e for e in prof.profiler.kineto_results.events()
              if str(e.device_type()).endswith("CPU")]
    assert not any(e.name() == "inner" for e in events)
    (outer,) = [e for e in events if e.name() == "outer"]
    lo, hi = outer.start_ns(), outer.start_ns() + outer.duration_ns()
    assert lo + 1_000_000 <= s.host_start_ns <= s.host_end_ns <= hi - 1_000_000, (
        lo, s.host_start_ns, s.host_end_ns, hi)


@pytest.mark.cuda
def test_device_intervals_nest_on_the_card():
    """On the card, over two steps, each span's interval on the stream
    holds its children's, and a step's device time is not less than the
    sum of its children's."""
    dev = device_of("cuda")
    model, opt, step, b = smoke(dev)
    model, opt, _ = step(model, opt, b)  # warm-up
    trace.enable(dev)
    model, opt, _ = step(model, opt, b)
    step(model, opt, b)
    trace.disable()
    spans = trace.take()
    roots = [s for s in spans if s.name == "train.step"]
    assert len(roots) == 2
    for r in roots:
        mine = [s for s in spans if s.step == r.id]
        check_step_spans(mine)
        children = sum(s.device_ms for s in mine if s.parent == r.id)
        assert 0 < children <= r.device_ms
    assert roots[0].device_end_ms <= roots[1].device_start_ms
