"""k5_fwd_roofline_pct.train: K5's forward launches in the profiled train
steps, the sum of their bounds over the sum of their device times, in %.

A step launches the forward once a layer and microbatch, twice with remat
(its recompute); each launch's bound is ``counts.k5_forward`` at the
microbatch's shape, the log-sum-exp included.  Launches are the kernels
whose names start with ``PREFIXES``; where their count is not the shapes'
the metric is left out."""

import sys

from benchlib import counts, spans

PREFIXES = ("flash_attention",)


def read(rec):
    p, steps = spans.profiled(rec, "train")
    if not steps:
        return None
    launches = p.kernels(spans.named(*PREFIXES))
    per_step = (2 if rec.traffic["remat"] else 1) * rec.conf["num_hidden_layers"]
    bound = 0.0
    for u in steps:
        A = u["microbatches"]
        t, which = counts.bound_s(*counts.k5_forward(rec.conf, u["batch"] // A, u["seq"], True))
        bound += per_step * A * t
    if not launches or len(launches) != sum(per_step * u["microbatches"] for u in steps):
        return None
    print(f"k5_fwd_roofline_pct.train: {which}-bound", file=sys.stderr)
    return 100.0 * bound / (spans.total_ns(launches) * 1e-9)
