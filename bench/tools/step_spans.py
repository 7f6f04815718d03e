"""The training step's split by the port's own spans, and what the span
recorder costs when it is on, for one cell in one process:

1. The cell's set-up, as a benchmark run makes it.
2. The recorder's cost: ``--windows`` windows of ``--seconds`` with the
   recorder off and as many with it on, in the order off on on off ...,
   each reporting ``train_tokens_per_s``.
3. The recorder pass: the traffic's ``profiled_steps`` + 1 steps with the
   recorder on and no profiler running. Its split gives the six numbers
   of :mod:`benchlib.program_spans`, and the accounting line is printed
   on standard error.
4. A device-only profile of as many steps with the recorder on. Each
   device operation's time goes to the span open on the host when it was
   launched (by the profiler's correlation ids), in all and by kind
   (elementwise as the benchmark reads it, GEMM, K5, copies and sets,
   other), beside the spans' own device ms.
5. A profile with host activity too, of as many steps with the recorder
   on. Its operations go to spans as in 4, its idle gaps are named by
   host operation, as the benchmark names them, and by program span, and
   its elementwise device time by the backward node and by the ATen
   operator that launched it.

    python3 bench/tools/step_spans.py --workload <cell> --seed <n> \
        --seconds 20 --windows 3 --out build/step_spans.json

The benchmark's runs do not run this. The result is one JSON object on
standard output, also written to ``--out``. ``PERF.md`` records what it
printed.
"""

import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path
from typing import NamedTuple

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))

from benchlib import program_spans as ps, spans  # noqa: E402

TOP = 15
NODE = "autograd::engine::evaluate_function: "  # a backward node's host range


class Interval(NamedTuple):
    """A host operation, shaped as a span for ``by_innermost_span``."""
    host_start_ns: int
    host_end_ns: int
    name: str


def ms(ns_by_name: dict, steps: int) -> dict:
    """Nanoseconds by name as ms a step, largest first."""
    return {k: v * 1e-6 / steps for k, v in sorted(ns_by_name.items(), key=lambda kv: -kv[1])}


def rate_windows(driver, device, seconds: float, windows: int) -> dict:
    """``train_tokens_per_s`` of windows alternately without and with the
    recorder, in the order off on on off off on ...; the spans a window
    with the recorder on recorded are counted, then dropped."""
    from repro_torch import trace

    order = [(i % 4) in (1, 2) for i in range(2 * windows)]
    out = {"order": ["on" if on else "off" for on in order], "off": [], "on": [],
           "spans_a_step": []}
    for on in order:
        if on:
            trace.enable(device)
        gc.collect()
        gc.freeze()
        units = driver.window(seconds)
        gc.unfreeze()
        trace.disable()
        taken = trace.take()
        out["on" if on else "off"].append(driver.end_to_end(units)["train_tokens_per_s"])
        if on:
            out["spans_a_step"].append(len(taken) / len(units))
    off, on = statistics.median(out["off"]), statistics.median(out["on"])
    out["on_over_off_pct"] = 100.0 * (on / off - 1.0)
    return out


# device operations by kind: K5, the benchmark's elementwise reading
# (``elementwise_ms_per_step.train``), GEMMs, copies and sets, the rest
KINDS = ("k5", "elementwise", "gemm", "copy", "other")


def kind(name: str) -> str:
    if not spans.is_kernel(name):
        return "copy"
    if spans.named("flash_attention", "flash_bwd")(name):
        return "k5"
    if spans.saying("elementwise", "reduce")(name):
        return "elementwise"
    if spans.saying("gemm", "nvjet", "cutlass", "xmma", "sm90")(name):
        return "gemm"
    return "other"


def by_span_and_kind(launches, records, steps: int) -> dict:
    """Device ms a step of the operations launched inside each span (the
    innermost open on the host at the launch), in all and by
    :func:`kind`."""
    out = {"all": ms(ps.by_innermost_span([(t, d) for t, d, _ in launches], records), steps)}
    for k in KINDS:
        out[k] = ms(ps.by_innermost_span([(t, d) for t, d, c in launches if c == k],
                                       records), steps)
    return out


def elementwise_by_host_op(launches, host, steps: int, prefix: str) -> dict:
    """Device ms a step of the elementwise operations by the innermost host
    operation open at their launch among those named ``prefix``..., the
    largest :data:`TOP` (``prefix`` :data:`NODE` names backward nodes)."""
    ops = [Interval(a, b, n[len(NODE):] if prefix == NODE else n)
           for a, b, n in host if n.startswith(prefix)]
    points = [(t, d) for t, d, k in launches if k == "elementwise"]
    return dict(list(ms(ps.by_innermost_span(points, ops), steps).items())[:TOP])


def profiled(driver, device, n: int, acts) -> tuple:
    """``n`` steps with the recorder on under ``torch.profiler`` with
    ``acts``: (spans, Profile, device operations as (launch time, device
    ns, :func:`kind`))."""
    from torch.profiler import profile, record_function

    from benchlib import harness
    from repro_torch import trace

    harness._sync(device)
    with profile(activities=acts) as prof:
        with record_function(spans.WINDOW_RANGE):
            harness._sync(device)
            trace.enable(device)
            units = driver.profile(n)
            trace.disable()
            harness._sync(device)
    records = trace.take()
    p = spans.from_profiler(prof, units)
    launched, kernels = {}, []
    for e in prof.profiler.kineto_results.events():
        corr = e.correlation_id()
        if not corr:
            continue
        if str(e.device_type()).endswith("CPU"):  # the launch (runtime or driver call)
            launched[corr] = min(e.start_ns(), launched.get(corr, e.start_ns()))
        elif not spans._annotation(e):
            kernels.append((corr, e.duration_ns(), kind(e.name())))
    launches = [(launched[c], d, k) for c, d, k in kernels if c in launched]
    return records, p, launches


def measure(man, cell: str, seed: int, device, seconds: float, windows: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity

    from benchlib import harness
    from repro_torch import trace

    dev = torch.device(device)
    driver = harness.make_driver(man, cell, seed, dev)
    t0 = time.perf_counter()
    driver.setup()
    harness._sync(dev)
    out = {"cell": cell, "seed": seed, "device": str(dev), "setup_s": time.perf_counter() - t0}
    if dev.type == "cuda":
        out["card"] = harness.card()
    n = driver.ctx.traffic["profiled_steps"] + 1
    out["rates"] = rate_windows(driver, dev, seconds, windows)

    trace.enable(dev)
    driver.profile(n)
    trace.disable()
    s = ps.split(trace.take())
    out["recorder_pass"] = s
    print(f"{cell} recorder pass: " + ps.accounting_line(s), file=sys.stderr)

    cuda = dev.type == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    records, p, launches = profiled(driver, dev, n, acts)
    s = ps.split(records)
    out["device_profile"] = {
        "split": s, "busy_ms_per_step": p.busy_ns() * 1e-6 / n,
        "ops_per_step": len(p.device) / n, "ops_matched_to_a_launch": len(launches) / n,
        "ops_ms_per_step_by_span": by_span_and_kind(launches, records, n)}
    print(f"{cell} under the device-only profile: " + ps.accounting_line(s), file=sys.stderr)

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    records, p, launches = profiled(driver, dev, n, acts)
    gaps = spans.idle_gaps(p.device, p.lo, p.hi)
    out["host_profile"] = {
        "split": ps.split(records), "window_ms_per_step": p.window_ns * 1e-6 / n,
        "busy_ms_per_step": p.busy_ns() * 1e-6 / n,
        "ops_ms_per_step_by_span":
            ms(ps.by_innermost_span([(t, d) for t, d, _ in launches], records), n),
        "idle_gaps_ms_per_step": dict(list(ms(p.gaps, n).items())[:TOP]),
        "idle_gaps_by_span_ms_per_step": ms(ps.gaps_by_span(gaps, records), n),
        "elementwise_ms_per_step_by_autograd_node":
            elementwise_by_host_op(launches, p.host, n, NODE),
        "elementwise_ms_per_step_by_aten_op": elementwise_by_host_op(launches, p.host, n, "aten::")}
    driver.free()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args()

    import run

    run._environment()  # the benchmark's caches and threads

    import torch

    from benchlib import manifest

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    out = measure(manifest.load(BENCH.parent), args.workload, args.seed, "cuda",
                  args.seconds, args.windows)
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
