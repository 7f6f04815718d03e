"""K5's kernels of two checkouts in turns on one card: the bf16 forward and
backward at the model shapes the port trains and serves, and the float32
forward and backward at phase 6's float32 case and qwen2-0.5b's training
shape, each beside SDPA on the same inputs and the bounds.

    python scripts/k5_bwd_compare.py --parent build/parent [--order PCCP]
        [--dtypes bfloat16,float32] [--out FILE]

``--parent`` is the root of another checkout of this repository (for
example ``git archive`` of the parent commit unpacked under ``build/``);
``C`` is this checkout.  Each letter of ``--order`` is one run in a
process of its own, which builds that checkout's kernels and times each
shape of ``--dtypes`` (CUDA events, median of 10 rounds of 2 calls, warm)
on the same seeded inputs: in bf16 ``flash_attention`` (prefill: o in
bf16, no log-sum-exp), ``flash_attention_fwd`` (o in float32 and the
log-sum-exp, as autograd calls it) and ``flash_attention_backward``; in
float32 ``flash_attention`` and ``flash_attention_backward``.  Each run
also gives the ``ptxas -v`` resources of its bf16 forward instances
(registers, spill bytes).  A float32 run also reads,
at draws of q, k, v of std 1, 2 and 3, the worst share of
``attention_limit`` (forward) and ``attention_bwd_limit`` (dq, dk, dv)
against the plain float32 version (``against_float32``, the limits as the
tests hold them) and against the float64 answer (``against_float64``,
``attention_exact``), beside the plain float32 version's own share against
float64 (the backward handed the float64 answer's o and lse there).  The
runs of this checkout also time SDPA
(``scaled_dot_product_attention``: causal, or the window as a boolean
mask; its backward by ``torch.autograd.grad``) and give the bounds: bf16
4 D (forward) and 10 D (backward) flops per unmasked (query, key) pair and
head at 989 TFLOP/s; float32
the flops at the CUDA cores' 67 TFLOP/s and as three TF32 products per
product (the split the kernels run) at the tensor cores' 495 TFLOP/s.  In
float32 they also name the kernels SDPA launches (``torch.profiler``) and
read its shares.  Prints one JSON line per run, then one per shape with
every run's times, and with ``--out`` writes them all to that file.  Needs
a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

# (label, dtype, BH, S, D, window): bf16 at qwen2-0.5b's training shape
# first, then the head dims of llama3.2-3b (128), phi-3-vision (96), the
# smoke llama (32) and hymba-1.5b's window of 2,048; float32 at phase 6's
# case (llama3.2-3b's attention width at S = 1,024) and qwen2-0.5b's
# training shape
SHAPES = (("qwen2-0.5b train", "bfloat16", 28, 4096, 64, None),
          ("llama3.2-3b", "bfloat16", 24, 4096, 128, None),
          ("phi-3-vision", "bfloat16", 32, 4096, 96, None),
          ("smoke llama", "bfloat16", 32, 4096, 32, None),
          ("hymba-1.5b", "bfloat16", 25, 4096, 64, 2048),
          ("llama3.2-3b f32", "float32", 24, 1024, 128, None),
          ("qwen2-0.5b train f32", "float32", 28, 4096, 64, None))
STDS = (1.0, 2.0, 3.0)
BF16_FLOPS_PER_S = 989e12
ALU_FLOPS_PER_S = 67e12    # float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12  # the tensor cores on TF32


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


def this_ref():
    """This checkout's ``kernels/flash_attn/ref.py`` (it imports only torch):
    both sides' kernels are read against the same plain versions and
    limits."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "src", "repro_torch", "kernels", "flash_attn", "ref.py")
    spec = importlib.util.spec_from_file_location("k5_compare_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def shares(fwd, bwd, q, k, v, do) -> dict:
    """Worst |got - want| / limit of ``fwd(q, k, v)`` and of ``bwd(q, k, v,
    o, lse, do)`` (dq, dk, dv; o and lse of the plain version) against the
    plain float32 version and against the float64 answer, and the plain
    float32 version's own against float64, over every element."""
    import torch

    ref = this_ref()
    attention_bwd_limit, attention_bwd_ref = ref.attention_bwd_limit, ref.attention_bwd_ref
    attention_exact, attention_limit = ref.attention_exact, ref.attention_limit
    attention_lse_ref, attention_ref = ref.attention_lse_ref, ref.attention_ref

    def worst(got, want, lim):
        return float(((got.double() - want.double()).abs() / lim).max())

    want32 = attention_ref(q, k, v)
    o64, lse64 = attention_exact(q, k, v)
    lim = attention_limit(q, k, v, want32)
    got = fwd(q, k, v)
    out = {"forward": {"against_float32": worst(got, want32, lim),
                       "against_float64": worst(got, o64, lim),
                       "plain_float32_against_float64": worst(want32, o64, lim)}}
    del got
    # against float32: o and lse of the plain float32 version, as the tests
    # hand them; against float64: o and lse of the float64 answer, so that
    # only the backward's own error is read
    args = (q, k, v, want32, attention_lse_ref(q, k, v), do)
    args64 = (q.double(), k.double(), v.double(), o64, lse64, do.double())
    exact = tuple(t.float() for t in args64)
    got = bwd(*args)
    out["backward_dq_dk_dv"] = {"against_float32": [
        worst(g, w, x) for g, w, x in zip(got, attention_bwd_ref(*args),
                                          attention_bwd_limit(*args))]}
    del got, want32, args
    wants64 = attention_bwd_ref(*args64)
    lims = attention_bwd_limit(*exact)
    out["backward_dq_dk_dv"].update(
        against_float64=[worst(g, w, x) for g, w, x in zip(bwd(*exact), wants64, lims)],
        plain_float32_against_float64=[worst(g, w, x) for g, w, x in zip(
            attention_bwd_ref(*exact), wants64, lims)])
    del wants64, lims, exact, args64, o64, lse64
    torch.cuda.empty_cache()
    return out


def sdpa_kernels(fn) -> list:
    """The CUDA kernels that ``fn`` launches, by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0))
            for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    rows.sort(key=lambda r: -r[1])
    return [{"kernel": key, "device_us": us} for key, us in rows[:4]]


def sdpa_calls(q, k, v, do, window):
    """SDPA's forward and its backward (``torch.autograd.grad``) on
    ``[BH, S, D]`` inputs, causal or windowed: two functions of no
    arguments."""
    import torch
    import torch.nn.functional as F

    bh, s, d = q.shape
    q4, k4, v4 = (t.view(1, bh, s, d).detach().requires_grad_() for t in (q, k, v))
    if window is None:
        kw = {"is_causal": True}
    else:
        pos = torch.arange(s, device=q.device)
        kw = {"attn_mask": (pos[None, :] <= pos[:, None])
              & (pos[None, :] > pos[:, None] - window)}
    y = F.scaled_dot_product_attention(q4, k4, v4, **kw)
    do4 = do.view(1, bh, s, d)
    return (lambda: F.scaled_dot_product_attention(q4, k4, v4, **kw),
            lambda: torch.autograd.grad(y, (q4, k4, v4), do4, retain_graph=True))


def sdpa_pair():
    """SDPA, causal, as (forward(q, k, v), backward(q, k, v, o, lse, do))
    on ``[BH, S, D]`` tensors, for :func:`shares`."""
    import torch
    import torch.nn.functional as F

    def fwd(q, k, v):
        bh, s, d = q.shape
        return F.scaled_dot_product_attention(
            *(t.view(1, bh, s, d) for t in (q, k, v)), is_causal=True).view(bh, s, d)

    def bwd(q, k, v, o, lse, do):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            return torch.autograd.grad(fwd(*leaves), leaves, do)

    return fwd, bwd


def bf16_shape(bh, s, d, window, library: bool) -> dict:
    import torch

    from repro_torch.kernels.flash_attn import (attention_pairs, flash_attention,
                                                flash_attention_backward,
                                                flash_attention_fwd)

    gen = torch.Generator(device="cuda").manual_seed(bh * s + d)
    q, k, v, do = (torch.randn((bh, s, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = flash_attention_fwd(q, k, v, window=window)
    rec = {"forward_ms": time_ms(lambda: flash_attention(q, k, v, window=window)),
           "forward_lse_ms": time_ms(lambda: flash_attention_fwd(q, k, v, window=window)),
           "backward_ms": time_ms(lambda: flash_attention_backward(q, k, v, o, lse, do,
                                                                   window=window))}
    if library:
        lib_fwd, lib_bwd = sdpa_calls(q, k, v, do, window)
        pairs = attention_pairs(s, window)
        rec.update(library_forward_ms=time_ms(lib_fwd), library_backward_ms=time_ms(lib_bwd),
                   forward_bound_ms=4 * d * bh * pairs / BF16_FLOPS_PER_S * 1e3,
                   backward_bound_ms=10 * d * bh * pairs / BF16_FLOPS_PER_S * 1e3)
    return rec


def f32_shape(bh, s, d, library: bool) -> dict:
    import torch

    from repro_torch.kernels.flash_attn import (attention_pairs, flash_attention,
                                                flash_attention_backward,
                                                flash_attention_fwd)

    gen = torch.Generator(device="cuda").manual_seed(bh * s + d)
    base = [torch.randn((bh, s, d), generator=gen, device="cuda") for _ in range(4)]
    q, k, v, do = base
    o, lse = flash_attention_fwd(q, k, v)
    rec = {"forward_ms": time_ms(lambda: flash_attention(q, k, v)),
           "backward_ms": time_ms(lambda: flash_attention_backward(q, k, v, o, lse, do)),
           "shares": {}}
    del o, lse

    def scaled(std):
        return [t * std for t in base[:3]] + [base[3]]

    for std in STDS:
        rec["shares"][str(std)] = shares(
            lambda a, b, c: flash_attention(a, b, c),
            lambda *a: flash_attention_backward(*a), *scaled(std))
    if library:
        lib_fwd, lib_bwd = sdpa_calls(q, k, v, do, None)
        pairs = attention_pairs(s)
        rec.update(
            library_forward_ms=time_ms(lib_fwd), library_backward_ms=time_ms(lib_bwd),
            library_forward_kernels=sdpa_kernels(lib_fwd),
            library_backward_kernels=sdpa_kernels(lib_bwd),
            forward_bound_cuda_cores_ms=4 * d * bh * pairs / ALU_FLOPS_PER_S * 1e3,
            forward_bound_split_tf32_ms=12 * d * bh * pairs / TF32_FLOPS_PER_S * 1e3,
            backward_bound_cuda_cores_ms=10 * d * bh * pairs / ALU_FLOPS_PER_S * 1e3,
            backward_bound_split_tf32_ms=30 * d * bh * pairs / TF32_FLOPS_PER_S * 1e3)
        del lib_fwd, lib_bwd
        fwd, bwd = sdpa_pair()
        rec["library_shares"] = {str(std): shares(fwd, bwd, *scaled(std)) for std in STDS}
    return rec


def worker(root: str, library: bool, dtypes) -> dict:
    """One run: build ``root``'s kernels, time every shape of ``dtypes``."""
    sys.path.insert(0, os.path.join(root, "src"))
    import torch

    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' products
    lib = _build.build()
    res = _build.resources((lib.parent / _build.PTXAS_LOG).read_text())
    out = {"root": root, "shapes": {},
           "bf16_forward_resources": {k: v for k, v in res.items()
                                      if "flash_attention_bf16" in k}}
    for label, dtype, bh, s, d, window in SHAPES:
        if dtype not in dtypes:
            continue
        out["shapes"][label] = (bf16_shape(bh, s, d, window, library) if dtype == "bfloat16"
                                else f32_shape(bh, s, d, library))
        torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="root of the other checkout")
    ap.add_argument("--order", default="PCCP")
    ap.add_argument("--dtypes", default="bfloat16,float32")
    ap.add_argument("--out", help="also write the runs and the table here (JSON)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--library", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    dtypes = args.dtypes.split(",")
    if args.worker:
        print(json.dumps(worker(args.worker, args.library, dtypes)), flush=True)
        return
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    runs = []
    for i, side in enumerate(args.order):
        root = here if side == "C" else os.path.abspath(args.parent)
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", root,
               "--dtypes", args.dtypes]
        if side == "C":
            cmd.append("--library")
        res = subprocess.run(cmd, capture_output=True, text=True, check=True, cwd=root)
        rec = {"run": i, "side": side, "nvidia_smi": smi,
               **json.loads(res.stdout.strip().splitlines()[-1])}
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    table = []
    for label, dtype, bh, s, d, window in SHAPES:
        if dtype not in dtypes:
            continue
        row = {"shape": label, "dtype": dtype, "bh": bh, "s": s, "d": d, "window": window,
               "nvidia_smi": smi}
        times = ("forward_ms", "backward_ms")
        if dtype == "bfloat16":
            times = ("forward_ms", "forward_lse_ms", "backward_ms")
        for side in "PC":
            mine = [r["shapes"][label] for r in runs if r["side"] == side]
            row[side] = {key: [x[key] for x in mine] for key in times}
        lib = [r["shapes"][label] for r in runs if r["side"] == "C"]
        if lib:
            row.update({key: [x[key] for x in lib] for key in lib[0]
                        if key.startswith("library_") and key.endswith("_ms")})
            row.update({key: lib[0][key] for key in lib[0] if "bound" in key})
        print(json.dumps(row), flush=True)
        table.append(row)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"runs": runs, "table": table}, f, indent=1)


if __name__ == "__main__":
    main()
