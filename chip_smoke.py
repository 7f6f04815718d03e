#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--sf 1.0]

Phases, each printing one JSON line:

1. device      — the card's name and power limit (``nvidia-smi``).
2. build       — compiles the CUDA kernel from ``src/repro_torch/kernels``.
3. kernel      — ``pred_filter_batch``, comparison variant (K1) and set
                 variant (K2), against its plain PyTorch version on the card
                 at TPC-H sf-1 lineitem widths: exact equality, CUDA-event
                 times (median of 20), the byte bound, and ``torch.isin`` as
                 the library yardstick of pure membership.
4. device_ratio — the launch path's marginal cost per row x atom over the
                 host numpy scan's (the cost model's device seed).
5. main path   — TPC-H q3 (comparison variant) and q12 (set variant) at
                 ``--sf`` through ``PredTrace(device="cuda")``: infer, run,
                 query(0), query_batch(first 16 rows), once with the device
                 cutovers forced to 0 and once auto-routed; answers must equal
                 the numpy backend's, and the forced run must launch both
                 kernel variants.

Then a ``{"kernels": [...]}`` line, the raw ``nvidia-smi`` line, and the
final ``{"ok": true, ...}`` line.  Any failure raises (exit code != 0); the
script refuses to run without a CUDA device.  It imports neither ``jax`` nor
the reference package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks from NVIDIA's data sheet (700 W): HBM bandwidth and the
# float32 rate outside the tensor cores, used for the int32 compares
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
SOURCE = "src/repro_torch/kernels/pred_filter/csrc/pred_filter.cu"
# the TPU kernel's two pallas_call sites in pred_filter_batch (:272)
REPLACES = {"cmp": "src/repro/kernels/pred_filter/pred_filter.py:293",
            "sets": "src/repro/kernels/pred_filter/pred_filter.py:310"}
CUTOVER_ENV = ("PREDTRACE_DEVICE_CUTOVER", "PREDTRACE_MEMBER_CUTOVER",
               "PREDTRACE_RLE_CUTOVER")


def emit(obj) -> None:
    print(json.dumps(obj, sort_keys=True), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# timing
# --------------------------------------------------------------------------- #
def time_ms(fn, reps: int = 20, inner: int = 5) -> float:
    """Median over ``reps`` of the device time of ``inner`` back-to-back calls
    of ``fn`` (per call), by CUDA events.  A spin kernel queued first keeps
    the card busy while the host enqueues, so host overhead is not timed."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(statistics.median(times))


def copy_bandwidth() -> float:
    """Measured device-to-device copy rate (bytes read + written per s)."""
    src = torch.empty(1 << 28, dtype=torch.int32, device="cuda")
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), reps=10, inner=3)
    return 2 * src.numel() * 4 / (ms * 1e-3)


# --------------------------------------------------------------------------- #
# phase 3: the kernel against its plain version
# --------------------------------------------------------------------------- #
def kernel_case(rng, n, k, a, set_sizes=(), c=4, block_rows=1024,
                pure=False, ops=(5, 2, 3, 1)):
    """Inputs at lineitem width: ``c`` int32 columns of ``n`` rows (column 0
    sorted like a date column, so zone pruning has blocks to skip; column 3
    in 1..50 like a quantity, so == and != hit), ``k`` bindings of ``a``
    compare atoms, atom j on column j % c with op ``ops[j % len(ops)]``, and
    per-binding sorted key sets of the given sizes for ``len(set_sizes[0])``
    set atoms.  ``pure``: membership only, riding the tautology atom
    ``>= INT32_MIN`` as the scan backend launches it."""
    from repro_torch.kernels.pred_filter import (block_bounds, pack_program,
                                                 search_iters)

    npad = n + (-n) % block_rows
    cols = np.zeros((c, npad), np.int32)
    cols[0, :n] = np.sort(rng.integers(19920101, 19981231, n))
    cols[1:, :n] = rng.integers(0, 1 << 20, (c - 1, n))
    cols[3, :n] = rng.integers(1, 51, n)
    m = len(set_sizes[0]) if set_sizes else 0
    set_cols = tuple(1 + (i % (c - 1)) for i in range(m))
    atoms = tuple((j % c, ops[j % len(ops)]) for j in range(a))
    thr = np.empty((k, a), np.int32)
    for j, (ci, op) in enumerate(atoms):
        if ci == 0:
            lo = rng.integers(19930101, 19980101, k)
            thr[:, j] = lo if op in (4, 5) else lo + 30_000
        elif ci == 3:
            thr[:, j] = rng.integers(1, 51, k)
        else:
            thr[:, j] = rng.integers(0, 1 << 20, k)
    if pure:
        atoms = ((set_cols[0], 5),)
        thr = np.full((k, 1), -(2 ** 31), np.int32)
    rows = tuple(ci for ci, _ in atoms) + set_cols
    lo, hi = block_bounds(cols, block_rows, rows)
    dev = torch.device("cuda")
    args = dict(cols=torch.from_numpy(cols).to(dev),
                thresholds=torch.from_numpy(thr).to(dev), atoms=atoms,
                blk_lo=torch.from_numpy(lo).to(dev),
                blk_hi=torch.from_numpy(hi).to(dev), block_rows=block_rows)
    keys_total = 0
    if m:
        segs, off = [], np.zeros((k, m), np.int32)
        ln = np.zeros((k, m), np.int32)
        pos = mx = 0
        for b in range(k):
            for i in range(m):
                ks = np.unique(rng.integers(0, 1 << 20, set_sizes[b][i]))
                segs.append(ks.astype(np.int32))
                off[b, i], ln[b, i] = pos, ks.size
                pos += ks.size
                mx = max(mx, ks.size)
        slab = np.concatenate(segs).astype(np.int32)
        keys_total = int(slab.size)
        args.update(set_cols=set_cols,
                    set_slab=torch.from_numpy(slab).to(dev),
                    set_off=torch.from_numpy(off).to(dev),
                    set_len=torch.from_numpy(ln).to(dev),
                    iters=search_iters(max(mx, 1)))
    # the atom program rides the per-launch operand upload on the main path
    args["program"] = torch.from_numpy(pack_program(atoms, set_cols)).to(dev)
    return args, dict(n=npad, k=k, a=a, m=m, c=c, keys=keys_total,
                      lo=lo, hi=hi, thr=thr)


def alive_blocks(args, meta) -> np.ndarray:
    """Blocks the zone check keeps (the data-dependent part of the work)."""
    from repro_torch.core.scan import _SetOps, _skipped_blocks

    g = meta["lo"].shape[1]
    set_ops = None
    if meta["m"]:
        set_ops = _SetOps(args["set_cols"], args["set_slab"].cpu().numpy(),
                          args["set_off"].cpu().numpy(),
                          args["set_len"].cpu().numpy(), args["iters"])
    skipped = _skipped_blocks(args["atoms"], meta["lo"], meta["hi"],
                              meta["thr"], set_ops=set_ops)
    return g - skipped


def run_kernel_case(rng, label, n, k, a, set_sizes=(), copy_bps=None,
                    library=False, ops=(5, 2, 3, 1)):
    from repro_torch.kernels.pred_filter import pred_filter_batch
    from repro_torch.kernels.pred_filter.ref import _batch_bool

    args, meta = kernel_case(rng, n, k, a, set_sizes, pure=library, ops=ops)
    got = pred_filter_batch(**args)
    want = _batch_bool(args["cols"], args["thresholds"], args["atoms"],
                       args.get("set_cols", ()), args.get("set_slab"),
                       args.get("set_off"), args.get("set_len"),
                       args.get("iters", 1))
    torch.cuda.synchronize()
    err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max().item())
    if err != 0 or not torch.equal(got, want):
        raise AssertionError(f"{label}: kernel differs from its plain version")
    ms = time_ms(lambda: pred_filter_batch(**args))
    plain_ms = time_ms(lambda: _batch_bool(
        args["cols"], args["thresholds"], args["atoms"],
        args.get("set_cols", ()), args.get("set_slab"), args.get("set_off"),
        args.get("set_len"), args.get("iters", 1)), reps=20, inner=1)
    # bytes this data needs: the referenced columns of the blocks the zone
    # check keeps, the K x N byte mask, the bounds, thresholds, program and
    # sets
    g_alive = alive_blocks(args, meta)
    ncols = len({ci for ci, _ in args["atoms"]} | set(args.get("set_cols", ())))
    rows_alive = g_alive * 1024
    nbytes = (ncols * 4 * rows_alive + meta["k"] * meta["n"]
              + 2 * 4 * (meta["a"] + meta["m"]) * meta["lo"].shape[1]
              + 4 * meta["k"] * (meta["a"] + 2 * meta["m"]) + 4 * meta["keys"]
              + 4 * (2 * meta["a"] + meta["m"]))
    iters = args.get("iters", 0)
    nops = meta["k"] * rows_alive * (meta["a"] + meta["m"] * (iters + 1))
    bound_ms = max(nbytes / HBM_BYTES_PER_S, nops / ALU_OPS_PER_S) * 1e3
    library_ms = None
    if library:
        col = args["cols"][args["set_cols"][0]]
        keys = args["set_slab"]
        lib = torch.isin(col, keys)
        if not torch.equal(lib, want[0]):
            raise AssertionError(f"{label}: torch.isin disagrees")
        library_ms = time_ms(lambda: torch.isin(col, keys), reps=20, inner=1)
    rec = dict(case=label, n=meta["n"], k=meta["k"], a=meta["a"], m=meta["m"],
               set_keys=meta["keys"], blocks_alive=int(g_alive),
               blocks=int(meta["lo"].shape[1]), max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_bytes=int(nbytes),
               bound_by="bytes" if nbytes / HBM_BYTES_PER_S
               >= nops / ALU_OPS_PER_S else "operations",
               bound_ms_copy=(nbytes / copy_bps * 1e3) if copy_bps else None,
               library_ms=library_ms)
    emit({"phase": "kernel", **rec})
    del args, got, want
    torch.cuda.empty_cache()
    return rec


def phase_kernels(n: int):
    rng = np.random.default_rng(1)
    copy_bps = copy_bandwidth()
    emit({"phase": "copy_bandwidth", "bytes_per_s": copy_bps,
          "datasheet_bytes_per_s": HBM_BYTES_PER_S})
    # the three cases together hold every op (0-5) against the plain version
    k1 = [run_kernel_case(rng, f"K1 k={k} ops={ops}", n, k, 4,
                          copy_bps=copy_bps, ops=ops)
          for k, ops in ((1, (5, 2, 3, 1)), (8, (4, 3, 2, 0)),
                         (64, (5, 2, 4, 1)))]
    k2 = [
        run_kernel_case(rng, "K2 pure membership k=1 m=1", n, 1, 1,
                        set_sizes=[[1 << 16]], copy_bps=copy_bps, library=True),
        run_kernel_case(rng, "K2 k=8 m=2", n, 8, 2,
                        set_sizes=[[4096, 2048]] * 8, copy_bps=copy_bps),
        run_kernel_case(rng, "K2 k=64 m=1", n, 64, 4,
                        set_sizes=[[1024]] * 64, copy_bps=copy_bps),
    ]
    return k1, k2


# --------------------------------------------------------------------------- #
# phase 4: the cost model's device seed
# --------------------------------------------------------------------------- #
def phase_device_ratio():
    """Marginal seconds per row x atom of the device launch path (cached
    slab, operand upload, kernel, mask readback) over the host numpy scan's
    (``dispatch.host_row_cost``) — the value ``cost.DEVICE_RATIO_CUDA``
    seeds."""
    from repro_torch.core import dispatch
    from repro_torch.core.scan import TorchBackend

    be = TorchBackend(device="cuda")
    rng = np.random.default_rng(3)
    a = 4
    sizes = (1 << 21, 1 << 23)
    slabs = {n: rng.integers(-1000, 1000, (a, n)).astype(np.int32) for n in sizes}
    thr = rng.integers(-1000, 1000, (1, a)).astype(np.int32)

    def best(n):
        be._bench_launch(slabs[n], thr)
        ts = []
        for _ in range(10):
            t0 = time.perf_counter()
            be._bench_launch(slabs[n], thr)  # ends in the mask readback
            ts.append(time.perf_counter() - t0)
        return min(ts)

    t1, t2 = best(sizes[0]), best(sizes[1])
    slope = (t2 - t1) / ((sizes[1] - sizes[0]) * a)
    rc = dispatch.host_row_cost()
    emit({"phase": "device_ratio", "device_s_per_row_atom": slope,
          "host_s_per_row_atom": rc, "ratio": slope / rc,
          "launch_s": {str(sizes[0]): t1, str(sizes[1]): t2}})


# --------------------------------------------------------------------------- #
# phase 5: the main path
# --------------------------------------------------------------------------- #
def _answers_equal(a, b) -> bool:
    if sorted(a.lineage) != sorted(b.lineage) or a.precise != b.precise:
        return False
    return all(np.array_equal(np.sort(np.asarray(a.lineage[t])),
                              np.sort(np.asarray(b.lineage[t])))
               for t in a.lineage)


def drive(db, qname, engine=None, device=None):
    """infer, run, query(0), query_batch(first 16 rows) with phase times."""
    from repro_torch.core import PredTrace
    from repro_torch.tpch import ALL_QUERIES

    plan = ALL_QUERIES[qname](db)
    pt = PredTrace(db, plan, scan_engine=engine, device=device)
    t = {}
    t0 = time.perf_counter()
    pt.infer()
    t["infer_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pt.run()
    t["run_s"] = time.perf_counter() - t0
    n = pt.exec_result.output.nrows
    if n == 0:
        raise AssertionError(f"{qname}: empty output")
    t0 = time.perf_counter()
    one = pt.query(0)
    t["query_s"] = time.perf_counter() - t0
    rows = list(range(min(16, n)))
    t0 = time.perf_counter()
    batch = pt.query_batch(rows)
    t["query_batch_s"] = time.perf_counter() - t0
    return pt, [one] + batch, t


def phase_main_path(sf: float):
    from repro_torch.core import ScanEngine
    from repro_torch.kernels.pred_filter import LAUNCHES, reset_launches
    from repro_torch.tpch import generate

    t0 = time.perf_counter()
    db = generate(sf=sf, seed=1)
    emit({"phase": "dbgen", "sf": sf, "seconds": time.perf_counter() - t0,
          "lineitem_rows": int(db["lineitem"].nrows),
          "orders_rows": int(db["orders"].nrows)})
    oracle = {}
    for q in ("q3", "q12"):
        _, answers, t = drive(db, q, engine=ScanEngine("numpy"))
        oracle[q] = answers
        emit({"phase": "main_path", "query": q, "route": "numpy", **t})
    launches = {}
    for route in ("forced", "auto"):
        if route == "forced":
            for k in CUTOVER_ENV:
                os.environ[k] = "0"
        reset_launches()
        stats = {}
        for q in ("q3", "q12"):
            pt, answers, t = drive(db, q, device="cuda")
            torch.cuda.synchronize()
            if len(answers) != len(oracle[q]) or not all(
                    _answers_equal(a, b) for a, b in zip(answers, oracle[q])):
                raise AssertionError(f"{q} ({route}): answers differ from numpy")
            st = pt.scan_engine.stats
            stats[q] = {"device_scans": st.device_scans,
                        "device_batch_scans": st.device_batch_scans,
                        "member_fused_scans": st.member_fused_scans,
                        "device_blocks_pruned": st.device_blocks_pruned}
            emit({"phase": "main_path", "query": q, "route": route,
                  "identical_to_numpy": True, **t, **stats[q]})
        launches[route] = dict(LAUNCHES)
        emit({"phase": "main_path_launches", "route": route,
              "launches": launches[route]})
        for k in CUTOVER_ENV:
            os.environ.pop(k, None)
    if launches["forced"]["cmp"] < 1 or launches["forced"]["sets"] < 1:
        raise AssertionError(f"forced main path missed a kernel variant: "
                             f"{launches['forced']}")
    return launches["forced"]


# --------------------------------------------------------------------------- #
def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=1.0,
                    help="TPC-H scale factor of the main-path phase")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device; the port's smoke run needs one")
    for mod in list(sys.modules):
        if mod.split(".")[0] in ("jax", "repro"):
            sys.exit(f"chip_smoke.py: {mod} must not be imported")
    # the port must be importable before anything is printed
    from repro_torch.kernels.pred_filter import _build

    t_start = time.perf_counter()
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    lib = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(str(lib), ROOT)})

    n_lineitem = 6_001_215  # TPC-H sf-1 lineitem rows
    k1, k2 = phase_kernels(n_lineitem)
    phase_device_ratio()
    launches = phase_main_path(args.sf)
    if any(m in sys.modules for m in ("jax", "repro")):
        raise AssertionError("jax or the reference package was imported")

    def entry(name, recs, variant):
        r = recs[0]
        return {"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[variant],
                "launches": int(launches[variant]),
                "max_abs_err": max(x["max_abs_err"] for x in recs),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "shape": r["case"]}

    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(json.dumps({"kernels": [
        entry("pred_filter_batch (comparison variant, K1)", k1, "cmp"),
        entry("pred_filter_batch (set variant, K2)", k2, "sets"),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
