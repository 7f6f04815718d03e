"""rmsnorm_ms_per_step.train: device milliseconds a profiled train step of
the RMSNorm kernels (``kernels/rmsnorm``: names starting ``rmsnorm``).

A microbatch runs the forward kernel once a norm call, the model's 2 a
layer twice under remat (its recompute) and the final norm once, and the
backward kernel and the kernel that sums its dw partials once a call of the
backward (2 a layer and the final norm).  Where the count of any of them
is not the shapes' (a program without these kernels, or a norm that ran
elsewhere) the metric is left out."""

from benchlib import spans

FORWARD = "rmsnorm_fwd"
BACKWARD = ("rmsnorm_bwd", "rmsnorm_dw")


def read(rec):
    p, steps = spans.profiled(rec, "train")
    if not steps:
        return None
    L = rec.conf["num_hidden_layers"]
    A = sum(u["microbatches"] for u in steps)
    want = {FORWARD: A * ((2 if rec.traffic["remat"] else 1) * 2 * L + 1)}
    want.update({name: A * (2 * L + 1) for name in BACKWARD})
    if any(len(p.kernels(spans.named(name))) != n for name, n in want.items()):
        return None
    return spans.total_ns(p.kernels(spans.named("rmsnorm"))) * 1e-6 / len(steps)
