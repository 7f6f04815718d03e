"""K5's bf16 backward kernel of two checkouts in turns on one card: the
time of ``flash_attention_backward`` at the model shapes the port trains
and serves, beside SDPA's backward and the bound.

    python scripts/k5_bwd_compare.py --parent build/parent [--order PCCP] [--out FILE]

``--parent`` is the root of another checkout of this repository (for
example ``git archive`` of the parent commit unpacked under ``build/``);
``C`` is this checkout.  Each letter of ``--order`` is one run in a
process of its own, which builds that checkout's kernels and times each
shape (CUDA events, median of 10 rounds of 2 calls, warm) on the same
seeded inputs.  The runs of this checkout also time SDPA's backward
(``torch.autograd.grad`` of ``scaled_dot_product_attention``: causal, or
the window as a boolean mask) and give the bound: 10 D flops per unmasked
(query, key) pair and head at 989 TFLOP/s.  Prints one JSON line per run,
then one per shape with every run's time, and with ``--out`` writes them
all to that file.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

# (label, BH, S, D, window): qwen2-0.5b's training shape first, then the
# head dims of llama3.2-3b (128), phi-3-vision (96), the smoke llama (32)
# and hymba-1.5b's window of 2,048
SHAPES = (("qwen2-0.5b train", 28, 4096, 64, None),
          ("llama3.2-3b", 24, 4096, 128, None),
          ("phi-3-vision", 32, 4096, 96, None),
          ("smoke llama", 32, 4096, 32, None),
          ("hymba-1.5b", 25, 4096, 64, 2048))
BF16_FLOPS_PER_S = 989e12


def time_ms(fn, reps: int = 10, inner: int = 2) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # the host enqueues while the card spins
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(statistics.median(times))


def worker(root: str, library: bool) -> dict:
    """One run: build ``root``'s kernels and time every shape."""
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn import (attention_pairs,
                                                flash_attention_backward,
                                                flash_attention_fwd)

    _build.build()
    out = {"root": root, "shapes": {}}
    for label, bh, s, d, window in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(bh * s + d)
        q, k, v, do = (torch.randn((bh, s, d), generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        o, lse = flash_attention_fwd(q, k, v, window=window)
        rec = {"ms": time_ms(lambda: flash_attention_backward(q, k, v, o, lse, do,
                                                              window=window))}
        if library:
            q4, k4, v4 = (t.view(1, bh, s, d).detach().requires_grad_() for t in (q, k, v))
            if window is None:
                y = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
            else:
                pos = torch.arange(s, device="cuda")
                keep = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
                y = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=keep)
            rec["library_ms"] = time_ms(lambda: torch.autograd.grad(
                y, (q4, k4, v4), do.view(1, bh, s, d), retain_graph=True))
            rec["bound_ms"] = (10 * d * bh * attention_pairs(s, window)
                               / BF16_FLOPS_PER_S * 1e3)
            del y, q4, k4, v4
        out["shapes"][label] = rec
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="root of the other checkout")
    ap.add_argument("--order", default="PCCP")
    ap.add_argument("--out", help="also write the runs and the table here (JSON)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--library", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.library)), flush=True)
        return
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    runs = []
    for i, side in enumerate(args.order):
        root = here if side == "C" else os.path.abspath(args.parent)
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", root]
        if side == "C":
            cmd.append("--library")
        res = subprocess.run(cmd, capture_output=True, text=True, check=True, cwd=root)
        rec = {"run": i, "side": side, "nvidia_smi": smi,
               **json.loads(res.stdout.strip().splitlines()[-1])}
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    table = []
    for label, bh, s, d, window in SHAPES:
        row = {"shape": label, "bh": bh, "s": s, "d": d, "window": window,
               "nvidia_smi": smi}
        for side in "PC":
            row[side] = [r["shapes"][label]["ms"] for r in runs if r["side"] == side]
        lib = [r["shapes"][label] for r in runs if r["side"] == "C"]
        if lib:
            row["library_ms"] = [x["library_ms"] for x in lib]
            row["bound_ms"] = lib[0]["bound_ms"]
        print(json.dumps(row), flush=True)
        table.append(row)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"runs": runs, "table": table}, f, indent=1)


if __name__ == "__main__":
    main()
