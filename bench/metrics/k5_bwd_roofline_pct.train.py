"""k5_bwd_roofline_pct.train: K5's backward in the profiled train steps,
the sum of its bounds over the device time of all its launches (every
pass), in %.

A step runs the backward once a layer and microbatch; its bound is
``counts.k5_backward`` at the microbatch's shape.  Launches are the
kernels whose names start with ``PREFIXES``; with none the metric is left
out."""

import sys

from benchlib import counts, spans

PREFIXES = ("flash_bwd",)


def read(rec):
    p, steps = spans.profiled(rec, "train")
    launches = p.kernels(spans.named(*PREFIXES)) if steps else []
    if not launches:
        return None
    L = rec.conf["num_hidden_layers"]
    bound = 0.0
    for u in steps:
        A = u["microbatches"]
        t, which = counts.bound_s(*counts.k5_backward(rec.conf, u["batch"] // A, u["seq"]))
        bound += L * A * t
    print(f"k5_bwd_roofline_pct.train: {which}-bound", file=sys.stderr)
    return 100.0 * bound / (spans.total_ns(launches) * 1e-9)
