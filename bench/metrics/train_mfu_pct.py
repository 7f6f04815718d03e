"""train_mfu_pct: the window's model FLOPs (``counts.train_step_flops``,
each step's) over the window's host time, as a share of the card's bf16
peak, in %."""

from benchlib import counts


def read(rec):
    steps = [u for u in rec.window if u["kind"] == "train"]
    if not steps:
        return None
    flops = sum(counts.train_step_flops(rec.conf, u["batch"], u["seq"]) for u in steps)
    return 100.0 * flops / rec.window_s / counts.BF16_FLOPS
