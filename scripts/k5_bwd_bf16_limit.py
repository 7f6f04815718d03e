"""Readings behind ``BWD_BF16_RMS_LIMIT`` (``repro_torch/kernels/flash_attn/
ref.py``): RMS(got - want) / RMS(want) of dq, dk and dv, ``want`` the plain
float32 backward (``attention_bwd_ref``), for the CPU emulation of the bf16
backward kernel's roundings (``attention_bwd_bf16``: P and dS to bf16
before their products) and for the coarser control that also rounds dP
(``attention_bwd_bf16_scores``), at every head dim the kernel is built for.

    PYTHONPATH=src python scripts/k5_bwd_bf16_limit.py [--max-s 4096]

Inputs are standard normal draws from numpy (seed from the shape) rounded
to bf16, o = ``attention_ref`` in float32 and lse = ``attention_lse_ref``,
as the forward kernel hands them to the backward.  Prints one JSON line per
shape and a last line with the largest emulation and smallest control
reading.  Runs on the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.kernels.flash_attn import (attention_bwd_bf16,
                                            attention_bwd_bf16_scores,
                                            attention_bwd_ref,
                                            attention_lse_ref, attention_ref,
                                            rms_ratio)


def readings(s: int, d: int, window, bh: int = 2) -> dict:
    rng = np.random.default_rng(s + d + (window or 0))
    q, k, v, do = (torch.from_numpy(rng.standard_normal((bh, s, d)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(4))
    o = attention_ref(q.float(), k.float(), v.float(), window=window)
    lse = attention_lse_ref(q, k, v, window=window)
    want = attention_bwd_ref(q, k, v, o, lse, do, window=window)
    emul = attention_bwd_bf16(q, k, v, o, lse, do, window=window)
    ctrl = attention_bwd_bf16_scores(q, k, v, o, lse, do, window=window)
    return {"S": s, "D": d, "window": window,
            "kernel_rms": [rms_ratio(a, b) for a, b in zip(emul, want)],
            "control_rms": [rms_ratio(a, b) for a, b in zip(ctrl, want)]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--max-s", type=int, default=4096)
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    worst, least = 0.0, float("inf")
    for d in (32, 64, 96, 128):
        for s in (64, 288, 1024, 4096):
            if s > args.max_s:
                continue
            for window in (None, 40, 100):
                rec = readings(s, d, window)
                print(json.dumps(rec), flush=True)
                worst = max(worst, *rec["kernel_rms"])
                least = min(least, *rec["control_rms"])
    print(json.dumps({"kernel_rms_max": worst, "control_rms_min": least}))


if __name__ == "__main__":
    main()
