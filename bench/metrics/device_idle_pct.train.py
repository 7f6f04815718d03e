"""device_idle_pct.train: the share of the untraced window in which the
card had no work, in %: 1 - (device busy a profiled step) / (the window's
time a step).  The busy time is the union of the device spans over the
profiled steps, a step's share of it; the time a step is the window's
host time over its steps, as ``train_tokens_per_s`` counts them.  The
window is the base because the profiler stretches a step that the host's
launches bound, so idle read over the profiled span reads the tracer too."""

from benchlib import spans


def read(rec):
    p, steps = spans.profiled(rec, "train")
    window = [u for u in rec.window if u["kind"] == "train"]
    if not steps or not window:
        return None
    busy_s = p.busy_ns() * 1e-9 / len(steps)
    return 100.0 * (1.0 - busy_s / (rec.window_s / len(window)))
