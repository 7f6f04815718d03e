"""elementwise_ms_per_step.train: device milliseconds a profiled train
step of the kernels whose names say elementwise or reduce (PyTorch's
``elementwise_kernel`` and ``reduce_kernel`` families: the model's glue and
the optimizer's per-leaf arithmetic)."""

from benchlib import spans

GLUE = spans.saying("elementwise", "reduce")


def read(rec):
    p, steps = spans.profiled(rec, "train")
    if not steps:
        return None
    return spans.total_ns(p.kernels(GLUE)) * 1e-6 / len(steps)
