"""The reduction of the port's own spans (``repro_torch.trace``) to the
training step's split.

The training step records these spans (``launch/steps.py``,
``models/model.py``). Each is read by one number of :func:`split`:

* ``train.step`` once a step; its device ends give ``between_steps_ms``;
* ``train.forward`` and ``train.backward`` once per microbatch;
* ``train.grad_accum`` once per microbatch, plus once for the division;
* ``optim.update`` once a step;
* ``model.head`` once per microbatch, inside ``train.forward``.

Nothing here imports the port: the spans are given.
"""

from __future__ import annotations

import heapq
import statistics
from typing import Dict, Optional, Sequence, Tuple

STEP = "train.step"
# per-layer metric -> the span whose device ms a step it reads
PER_STEP = {"forward_ms_per_step.train": "train.forward",
            "backward_ms_per_step.train": "train.backward",
            "grad_accum_ms_per_step.train": "train.grad_accum",
            "optimizer_ms_per_step.train": "optim.update",
            "head_fwd_ms_per_step.train": "model.head"}
BETWEEN = "between_steps_ms.train"
# the parts that tile a step and the gap after it (the head lies inside
# the forward)
PARTS = ("forward_ms_per_step.train", "backward_ms_per_step.train",
         "grad_accum_ms_per_step.train", "optimizer_ms_per_step.train", BETWEEN)
NO_SPAN = "no program span"


def split(records: Sequence) -> Optional[dict]:
    """The training step's split over ``records`` of whole steps: each
    metric of :data:`PER_STEP` (device ms a step inside its span, summed
    over the step's instances); :data:`BETWEEN`, the device ms from one
    ``train.step``'s end marker to the next one's start marker, averaged
    over the boundaries (absent with one step); the device ms of a step
    (its own span plus the mean gap after it); the share of that time the
    :data:`PARTS` account for, in %; and each span's host and device ms a
    step. None where the records hold no step."""
    steps = sorted((r for r in records if r.name == STEP), key=lambda r: r.device_start_ms)
    if not steps:
        return None
    n = len(steps)
    host: Dict[str, float] = {}
    device: Dict[str, float] = {}
    for r in records:
        host[r.name] = host.get(r.name, 0.0) + r.host_ms / n
        device[r.name] = device.get(r.name, 0.0) + r.device_ms / n
    metrics = {m: device[name] for m, name in PER_STEP.items() if name in device}
    gaps = [b.device_start_ms - a.device_end_ms for a, b in zip(steps, steps[1:])]
    step_ms = device[STEP] + (statistics.fmean(gaps) if gaps else 0.0)
    if gaps:
        metrics[BETWEEN] = statistics.fmean(gaps)
    parts = sum(metrics.get(m, 0.0) for m in PARTS)
    return {"steps": n, "metrics": metrics, "step_device_ms": step_ms,
            "accounted_pct": 100.0 * parts / step_ms if step_ms > 0 else None,
            "host_ms_per_step": host, "device_ms_per_step": device}


def accounting_line(s: dict) -> str:
    """One line: the parts' sum against the device time a step, then each
    span's host and device ms a step."""
    m = s["metrics"]
    parts = " + ".join(f"{m[k]:.3f}" for k in PARTS if k in m)
    per_span = ", ".join(f"{k} {s['host_ms_per_step'][k]:.3f} / {v:.3f}"
                         for k, v in sorted(s["device_ms_per_step"].items()))
    return (f"program spans over {s['steps']} steps: forward + backward + grad_accum + "
            f"optimizer + between_steps = {parts} = {sum(m.get(k, 0.0) for k in PARTS):.3f} "
            f"ms of {s['step_device_ms']:.3f} ms a step on the device "
            f"({s['accounted_pct']:.2f}%); host / device ms a step: {per_span}")


def gaps_by_span(gaps: Sequence[Tuple[int, int]], records: Sequence) -> Dict[str, int]:
    """Idle nanoseconds by program span: each gap ``(start, end)`` of a
    profile (on the profiler's clock, as the spans' host times are) goes
    to the innermost span open on the host at its middle."""
    return by_innermost_span([((a + b) // 2, b - a) for a, b in gaps], records)


def by_innermost_span(points: Sequence[Tuple[int, int]], records: Sequence) -> Dict[str, int]:
    """The weights of ``points`` ``(t, weight)``, ``t`` on the profiler's
    clock, summed by the innermost span of ``records`` (the latest to
    start) open on the host at ``t``, or under :data:`NO_SPAN`."""
    events = sorted((r.host_start_ns, r.host_end_ns, r.name) for r in records)
    out: Dict[str, int] = {}
    active: list = []  # (-start, end, name)
    i = 0
    for t, w in sorted(points):
        while i < len(events) and events[i][0] <= t:
            a, b, n = events[i]
            heapq.heappush(active, (-a, b, n))
            i += 1
        # a span that ended before ``t`` ended before every later point too
        while active and active[0][1] < t:
            heapq.heappop(active)
        name = active[0][2] if active else NO_SPAN
        out[name] = out.get(name, 0) + w
    return out
