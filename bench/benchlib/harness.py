"""One run of one cell: set-up, the measured window, the traced part, the
check, and the result line.

The order is fixed: the driver's set-up (the port's objects built, every
shape of the cell warmed up) ends ``setup_s``; the window runs untraced
for ``seconds``; with ``trace`` the profiler then covers the driver's
profiled units; the device's peak memory is read; the port's state is
freed; and only then does the reference run, so it neither counts in
``setup_s`` nor sets the peak.
"""

from __future__ import annotations

import gc
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from benchlib import spans
from benchlib.manifest import Manifest


@dataclass
class Context:
    """What a driver is given: the configuration file, the traffic, the
    seed, the device, and the reference modules (model and optimizer)."""
    conf: dict
    traffic: dict
    seed: int
    device: torch.device
    reference: object
    optimizer: object


@dataclass
class Record:
    """What a per-layer metric's reader reads: the configuration and
    traffic, the window's units (each with its shapes and host times) and,
    in a traced run, the profile of the units after it."""
    conf: dict
    traffic: dict
    window: List[dict]
    profile: Optional[spans.Profile]

    @property
    def window_s(self) -> float:
        return self.window[-1]["end"] - self.window[0]["start"]


def make_driver(manifest: Manifest, cell: str, seed: int, device):
    c = manifest.cells[cell]
    conf = manifest.config(c.config)
    traffic = manifest.traffic(c.traffic)
    ctx = Context(conf, traffic, seed, torch.device(device),
                  manifest.reference(conf["reference"]), manifest.reference("adamw"))
    return manifest.driver(traffic["driver"]).Driver(ctx)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _traced(driver, device, acts, units=None):
    from torch.profiler import profile as torch_profile, record_function

    _sync(device)
    with torch_profile(activities=acts) as prof:
        with record_function(spans.WINDOW_RANGE):
            _sync(device)
            done = driver.profile(units)
            _sync(device)
    return spans.from_profiler(prof, done)


def profile(driver, device) -> spans.Profile:
    """The driver's profiled units under ``torch.profiler``.  On the card
    they are traced with device activity alone, from their first device
    operation to their last: tracing the host as well stretched a training
    step from 1.1 to 1.9 s, which would read as idle device time.  One more
    unit is then traced with host activity too, only to name the idle gaps
    by what the host was doing."""
    from torch.profiler import ProfilerActivity

    if torch.device(device).type != "cuda":
        return _traced(driver, device, [ProfilerActivity.CPU])
    prof = _traced(driver, device, [ProfilerActivity.CUDA])
    named = _traced(driver, device, [ProfilerActivity.CPU, ProfilerActivity.CUDA], 1)
    prof.gaps = named.gaps
    return prof


def card() -> str:
    """The card's name and power limit, which bound what a roofline share
    can reach (a card below 700 W runs slower under load), and its clock,
    draw and temperature as the window closes."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
                              "power.draw,temperature.gpu", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip().replace("\n", "; ")


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number that has a limit within it (a missing or non-finite
    number is not).  A number the cell gives no limit is not compared: no
    control or fault separated it from sound runs."""
    return all(k in numbers and numbers[k] == numbers[k] and numbers[k] <= limits[k]
               for k in limits)


def run_cell(manifest: Manifest, cell: str, seed: int, seconds: float, trace: bool,
             device, t_start: float) -> dict:
    """The result of one run, as the benchmark prints it."""
    dev = torch.device(device)
    driver = make_driver(manifest, cell, seed, dev)
    limits = manifest.cell_file(cell)["limits"]
    t_driver = time.perf_counter()
    driver.setup()
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    print(f"set-up: {t_driver - t_start:.3f} s to the driver (imports, the manifest), "
          f"{setup_s - (t_driver - t_start):.3f} s in it: {driver.setup_times}",
          file=sys.stderr)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # the set-up's objects out of the collector's way, so that no full
    # collection over the imported libraries pauses a step of the window
    gc.collect()
    gc.freeze()
    units = driver.window(seconds)
    gc.unfreeze()
    e2e = dict(driver.end_to_end(units), setup_s=setup_s)
    print(driver.shape_check(units), file=sys.stderr)
    took = sorted(u["end"] - u["start"] for u in units)
    print(f"window: {len(units)} units in {units[-1]['end'] - units[0]['start']:.4f} s, "
          f"a unit {took[0]:.4f} / {took[len(took) // 2]:.4f} / {took[-1]:.4f} s "
          f"(least / median / most)", file=sys.stderr)
    if dev.type == "cuda":
        print(f"card: {card()}", file=sys.stderr)
    prof = profile(driver, dev) if trace else None
    if prof is not None:
        print(f"profiled: {len(prof.units)} units, device busy {prof.busy_ns() * 1e-9:.4f} s "
              f"of a traced span of {prof.window_ns * 1e-9:.4f} s (the tracer's cost in it)",
              file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    driver.free()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = driver.check()
    failed = sum(not u["ok"] for u in units)
    correct = judge(numbers, limits) and failed == 0

    if trace:
        rec = Record(driver.ctx.conf, driver.ctx.traffic, units, prof)
        metrics = {}
        for m in manifest.cell_metrics(cell, "per_layer"):
            value = manifest.reader(m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in manifest.cell_metrics(cell, "end_to_end")}
    result = {"correct": correct, "attempted": len(units), "failed": failed,
              "metrics": metrics, "device": device_record(dev, peak)}
    if trace:
        result["device"].update(busy_s=prof.busy_ns() * 1e-9, window_s=prof.window_ns * 1e-9)
        result["breakdown"] = prof.breakdown()
    result["check"] = {k: {"value": numbers.get(k), "limit": v} for k, v in limits.items()}
    return result


def device_record(dev: torch.device, peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": peak}


def print_check(check: dict, stream=sys.stderr) -> None:
    for k, v in check.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=stream)
