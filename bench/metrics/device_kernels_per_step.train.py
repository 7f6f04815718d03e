"""device_kernels_per_step.train: device kernels (copies and sets left
out) the profiler saw over the profiled train steps, per step."""

from benchlib import spans


def read(rec):
    p, steps = spans.profiled(rec, "train")
    if not steps:
        return None
    return len(p.kernels()) / len(steps)
