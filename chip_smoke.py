#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--sf 1.0]

Phases, each printing one JSON line:

1. device      — the card's name and power limit (``nvidia-smi``).
2. build       — compiles the CUDA kernels from ``src/repro_torch/kernels``,
                 then prints ``k5_bwd_resources`` (registers, spill bytes
                 and dynamic shared memory of every instance of K5's
                 kernels: the bf16 forward in both output types, the bf16
                 backward, the float32 forward and backward, from
                 ``ptxas -v`` in the build
                 directory, with ptxas's warnings about them) and
                 ``k5_bwd_sass`` (their ``HGMMA``, ``UTMALDG`` and
                 ``HMMA`` instructions in ``cuobjdump -sass`` of the
                 library): each must run on wgmma with TMA loads and no
                 ``mma.sync``.
3. kernel      — ``pred_filter_batch``, comparison variant (K1) and set
                 variant (K2), against its plain PyTorch version on the card
                 at TPC-H sf-1 lineitem widths: exact equality, CUDA-event
                 times (median of 20), the byte bound, and ``torch.isin`` as
                 the library yardstick of pure membership (with K4's kernel
                 on the same random keys beside it).
4. device_ratio — the launch path's marginal cost per row x atom over the
                 host numpy scan's (the cost model's device seed), then one
                 ``route_ratio`` line for each other seeded route (host
                 in-situ compares, K2 membership through the torch backend,
                 run-space RLE on the card, in-situ compares over a demoted
                 stage's memmaps), each naming the ``core/cost.py``
                 constant it seeds.
5. main path   — TPC-H q3 (comparison variant) and q12 (set variant) at
                 ``--sf`` through ``PredTrace(device="cuda")``: infer, run,
                 query(0), query_batch(first 16 rows), once with the device
                 cutovers forced to 0 and once auto-routed; answers must equal
                 the numpy backend's, and the forced run must launch both
                 kernel variants.  The forced run's launches keep their
                 operands; afterwards each is replayed against the plain
                 version with times and bound (``main_path_kernel`` lines;
                 a launch of one binding of one atom also against the single
                 PyTorch comparison that computes it, its library
                 yardstick, both also timed with the L2 flushed), and the
                 kernels line reports K1 and K2 at these shapes.
6. entry points — the three other kernels through their own entry points,
                 with every launch count at 0 just before: ``scan_mask`` (K3,
                 TPC-H q6's int32 atoms over phase 5's lineitem), ``probe``
                 (K4, ``l_orderkey`` against sets of 5,000 and 65,536 keys and
                 q3's order keys; timed also on random values) and
                 ``mha_flash`` (K5, the attention widths
                 of llama3.2-3b and hymba-1.5b at S = 4,096 in bf16, and
                 llama3.2-3b at S = 1,024 and qwen2-0.5b's training widths
                 at S = 4,096 in float32).  Each answer is checked
                 (the numpy mask, ``torch.isin``, the plain attention within
                 ``attention_limit``); then each kernel against its plain
                 version with times, bound and the library yardstick
                 (``torch.isin``, ``scaled_dot_product_attention``), one line
                 per case; K5's lines give the worst and median share of
                 the per-element limit and RMS(err) / RMS(want), held in
                 bf16 to ``BF16_RMS_LIMIT``, which a control that rounds
                 the scores to bf16 must fail.  K5's backward kernel on
                 each attention case's operands (o and lse from the
                 forward kernel, each first held to its plain version:
                 lse within 2e-5 (1 + |lse|) of ``attention_lse_ref``, the
                 float32 o unrounded within ``attention_limit``; a seeded
                 dO) against ``attention_bwd_ref``:
                 float32 within ``attention_bwd_limit`` per element, bf16
                 each of dq, dk, dv within ``BWD_BF16_RMS_LIMIT``, which a
                 control that rounds the scores must exceed; bit-equal
                 over two runs; timed beside the plain version, SDPA's
                 backward and its bound (10 D flops per unmasked pair; in
                 float32 three TF32 products each, 30 D at the TF32 rate,
                 with the CUDA cores' 10 D at 67 TFLOP/s beside it).
7. serve       — run between phases 5 and 6 on phase 5's catalog: q3 and
                 q12 through ``LineageService`` (``launch/lineage_serve.py``'s
                 workload: 4 clients, 64 requests in pages of 16, Zipf 1.5
                 over output rows, a 3 ms window, batches of at most 32, plus
                 lone requests that ``query()`` answers) with a RAM budget of
                 0 and an unlimited disk tier, so every materialized stage is
                 demoted to memmapped spill files; once with the device
                 cutovers forced to 0 and once auto-routed.  In the forced
                 run a stored stage's scan takes the device route wherever
                 the store offers one, and every scan of a demoted stage
                 must have run on the card.  The forced run then appends
                 twice through ``encode_delta_like`` and ``run_delta`` (1%
                 new orders with their lineitems, then 1% more lineitems of
                 existing orders under fresh line numbers) and serves the
                 same requests again.
                 Every answer equals a numpy-backend PredTrace with a RAM
                 store on the same catalog; lines carry the demote bytes and
                 seconds, the service's stats (coalesce width, cache hit and
                 stale rates, ``delta_hits``, ``disk_tier_answers``, p50 and
                 p99), the engine's route counts and each stored stage's
                 routes by tier, each ``DeltaReport``, the
                 slab uploads after each append and the ``disk_scan_probe``
                 cutover.  The forced run's K1/K2 launches are counted from 0
                 and kept; each is replayed against the plain version and the
                 largest of each variant is timed beside its bound.
8. partition   — after phase 7, on phase 5's catalog: q3 and q12 through the
                 partition runtime, rows 0-3 by ``query``, ``query_batch``
                 and ``query_iterative`` (or ``distributed_refine``), every
                 answer identical to an unpartitioned numpy-backend
                 PredTrace: ``PredTrace(num_partitions=64, parallel=4)``
                 forced (cutovers 0, the device carry taken wherever the
                 kernel can take the program) and auto-routed,
                 ``PredTrace(mesh=("cuda:0",))``, and ``distributed_refine``
                 over ``("cuda:0",)`` with and without 64 partitions and
                 over ``("cuda:0", "cuda:0")``.  Lines carry each run's K1/K2
                 launches by route (carry, shard, partitioned, engine), the
                 partition counters, the slab uploads (a shard slab uploaded
                 twice in one run fails it) and each call's seconds; the
                 measured pool cutover has its own line.  Every launch is
                 replayed against the plain version and the largest of each
                 route and variant is timed beside its bound.
9. baselines   — the paper's comparison at phase 5's scale: the coverage
                 profile over the 22 TPC-H queries (PredTrace 22, Trace 12,
                 Panda 5), then for q3 and q12 PredTrace's ``query(0)`` on
                 the card against each lazy baseline that supports the
                 query, every answer equal to the eager oracle.
10. lm         — after phase 6, with the catalog freed and K5's launch
                 count at 0: the LM serving path at full width and depth in
                 bf16, weights from a seeded generator on the card.
                 llama3.2-3b (28 layers): ``make_prefill_step`` at B = 1,
                 S = 4,096, a warm-up and the median of 3 (host seconds to a
                 synchronise, tokens/s, peak memory, the model FLOP rate
                 over the bf16 peak, K5's share of prefill), each call
                 launching K5 once a layer;
                 every launch of the phase must come from a prefill call.
                 The first and last layer's launches are replayed against
                 the plain version afterwards (within ``attention_limit``
                 and ``BF16_RMS_LIMIT``) and timed beside SDPA.  A
                 1,024-token prompt through ``prefill`` and
                 token by token through ``decode_step`` (plain attention)
                 gives the same top-1 token, RMS(diff) / RMS(logits) <=
                 5e-2.  ``launch/serve.py``'s main: 4 prompts of 128
                 tokens, 32 generated each.  hymba-1.5b (32 layers, window
                 2,048): prefill at S = 4,096 (its launches kept and
                 replayed the same way), timed once after a warm-up, and
                 at S = 512.  phi-3-vision-4.2b (32 layers, d 3,072, head
                 dim 96; 256 patch embeddings before 3,840 tokens): prefill
                 at S = 4,096, replayed the same way.  The smoke llama
                 (``smoke_config``: 4 layers, head dim 32): a prefill at
                 S = 4,096 and one train step at B = 8, S = 4,096 (4 K5
                 backward launches, all of the phase's), its first K5
                 launch replayed.  The replayed layer 0 of each model (head
                 dims 128, 64, 96 and 32) also gets the backward kernel, as
                 in phase 6.  ``--only-lm`` runs phases 1, 2 and 10 alone.
11. train      — after phase 10, with its models freed.  First the
                 RMSNorm kernels alone (``rmsnorm`` lines): the model's
                 norm under autograd at qwen2-0.5b's training microbatch
                 [16,384, 896] in bf16 and float32, a llama3.2-3b prefill
                 [4,096, 3,072] and decode's [16, 896], y's rounding
                 points, dx and dw within ``kernels/rmsnorm/ref.py``'s
                 limits of float64, reruns bit-equal; each way's device ms
                 with the operands out of L2 beside the bytes bound at
                 3.35 TB/s, the eager op (plain) and ``F.rms_norm``
                 (library); then ``rmsnorm_host``, the host's microseconds
                 a call at decode's shape (the kernels' route and the
                 eager op under autograd, the launches direct and through
                 the operators).  Then, every launch count at 0, the
                 training path at full width and depth; each step must
                 launch the norm's forward kernel 4 x 97 and its backward
                 4 x 49 times.
                 qwen2-0.5b (``launch/train``'s default arch, 24 layers,
                 633 M parameters: bf16 matrices, float32 norms and qkv
                 biases), weights from a seeded generator on the card;
                 batches from ``LineageDataPipeline`` over 2,000 synthetic
                 documents, built and traced on the card with the cutovers
                 forced to 0 (``lineage_of`` the first document of step 0
                 identical to the numpy backend; its K1/K2 launches
                 replayed against the plain version).  ``make_train_step``
                 with remat, B = 8 at S = 4,096 in 4 microbatches of 2: a
                 warm-up step and 5 timed ones (median seconds, tokens/s,
                 peak memory, the model FLOP rate over the bf16 peak, every
                 loss finite), K5 192 launches a step (forward and remat
                 recompute, 24 layers, 4 microbatches) and its backward
                 kernel 96 (a layer and microbatch); during the timed steps
                 a call of the plain attention or its backward on a CUDA
                 tensor raises.  A checkpoint
                 after step 3 restored into a fresh model and AdamW state
                 bit-identical, whose step 4
                 gives the uninterrupted loss within 1e-3.  One
                 microbatch's gradients through K5's autograd node (the
                 forward and backward kernels) against the plain attention
                 under autograd: every parameter within RMS ratio 5e-2,
                 non-zero q/k/v gradients.  qwen2-0.5b in float32
                 (``dtype="float32"``): ``make_train_step`` with remat, B =
                 2 at S = 4,096, one microbatch, a warm-up step and a timed
                 one (seconds, peak memory; K5's float32 forward 48
                 launches and its backward 24, the plain attention raising
                 on the card), then the same gradient check in float32
                 at RMS ratio 2e-5; K5's float32 kernels on the q, k, v
                 the warm-up step gave its layer of the largest std(q)
                 std(k), within the float32 limits of the plain version
                 and of the float64 answer.
                 ``launch/train.py``'s main: 6
                 steps of batch 4 at S = 512, a checkpoint after the sixth.
                 Then the warm-up step's first K5 launch against the plain
                 version, timed beside SDPA, and the backward kernel on its
                 operands as in phase 6, timed beside ``attention_bwd_ref``,
                 autograd through the plain attention (the node's backward
                 before the kernel) and SDPA's backward.  ``--only-train``
                 runs phases 1, 2, 11 and 13 alone.
12. mesh       — after phase 11, with its models freed and every launch
                 count at 0: the same paths sharded over a ``DeviceMesh``
                 (``make_host_mesh(data=WORLD_SIZE, model=1)``, one NCCL
                 rank here), DTensor weights placed by ``tree_sharding``.
                 qwen2-0.5b through ``build_train(fsdp=True)`` at phase
                 11's shape: the first step's loss and weights against the
                 unsharded step from the same seed and batch (loss and
                 clip norm within 1e-5, weights within an eighth of the
                 step's learning rate), every K5 launch of that step held
                 to the plain version at once, then 5 timed steps (median,
                 tokens/s, peak memory), K5 192 launches and its backward
                 96 a step on the ranks' own shards, the plain attention
                 raising on the card; the sharded
                 train state saved and restored through
                 ``restore(shardings=)`` bit-identical.  llama3.2-3b
                 through ``build_prefill`` at S = 4,096 against
                 ``Model.prefill`` (RMS ratio <= 5e-2, the same top-1),
                 28 launches a call, each of the first call's held to the
                 plain version; ``build_decode``: 16 prompt tokens and
                 16 greedy ones, the same tokens as the unsharded decode.
                 ``distributed_refine`` over the mesh for q3 and q12 row 0
                 at sf 1, identical to numpy, its K1/K2 launches replayed
                 against the plain version.  Kept K5 launches are replayed
                 as in phase 11.  ``--only-mesh`` runs phases 1, 2 and 12
                 alone.
13. bound      — after phase 12, its process group closed: the dry run
                 (``launch/dryrun.py``) traces phase 11's step on fake
                 tensors over a one-rank mesh of a fake process group,
                 nothing on the card, and prints its compute, memory and
                 collective terms at the H100's constants
                 (``launch/roofline.py``), the dominant term and the bound,
                 beside phase 11's measured step and the bound's share of
                 it, with the trace's seconds.

Then a ``{"kernels": [...]}`` line (K1/K2's launches are phases 5, 11 and
12's, K5's and its backward's phases 10, 11 and 12's, the RMSNorm
kernels' phase 11's; K5's
``head_dim_cases`` give the head dims 96 and 32, its backward's every head
dim), the raw ``nvidia-smi`` line, and the
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
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks from NVIDIA's data sheet (700 W): HBM bandwidth, the
# float32 rate outside the tensor cores (also used for the int32 compares)
# and the dense bf16 and TF32 tensor-core rates
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
# K5's float32 kernels run each product as three TF32 products (split TF32)
SOURCE = "src/repro_torch/kernels/pred_filter/csrc/pred_filter.cu"
# the TPU kernels' pallas_call sites: pred_filter_batch (:272) has two
REPLACES = {"cmp": "src/repro/kernels/pred_filter/pred_filter.py:293",
            "sets": "src/repro/kernels/pred_filter/pred_filter.py:310",
            "single": "src/repro/kernels/pred_filter/pred_filter.py:119",
            "membership": "src/repro/kernels/membership/membership.py:46",
            "flash_attention": "src/repro/kernels/flash_attn/flash_attn.py:92"}
# attention widths of two models the repo configures, at its train_4k
# sequence length (src/repro/models/config.py): (name, config, dtype, S, H,
# D, window); H is GQA-expanded
ATTN_CASES = (
    ("llama3.2-3b", "src/repro/configs/llama3_2_3b.py", "bfloat16", 4096, 24,
     128, None),
    ("hymba-1.5b", "src/repro/configs/hymba_1_5b.py", "bfloat16", 4096, 25, 64,
     2048),
    ("llama3.2-3b", "src/repro/configs/llama3_2_3b.py", "float32", 1024, 24,
     128, None),
    # qwen2-0.5b's training widths: B 2 x 14 heads
    ("qwen2-0.5b", "src/repro/configs/qwen2_0_5b.py", "float32", 4096, 28, 64,
     None),
)
# kernel vs plain attention: ``attention_limit`` (kernels/flash_attn/ref.py)
# per element; float32 2e-5 + 2e-5 |want|; bf16 one ulp of the value (2**-7
# of it) plus 2**-8 (A |V|) for P rounded to bf16 before P V, plus 1e-3
# the PyTorch call that computes K1 at one binding of one atom, by op code
TORCH_COMPARE = (torch.eq, torch.ne, torch.lt, torch.le, torch.gt, torch.ge)
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


def time_ms_cold(fn, reps: int = 20) -> float:
    """Median device time of one call of ``fn`` right after 256 MB are
    written, which evicts the 50 MB L2: what a caller that finds its
    operands in device memory, not in L2, waits.  ``time_ms`` repeats the
    call back to back, so operands under 50 MB stay in L2 there.  A spin
    kernel (no memory traffic) between the flush and the start event keeps
    the host's launch work out of the timed span."""
    flush = torch.empty(1 << 26, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.fill_(reps)
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
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
    args, meta = kernel_case(rng, n, k, a, set_sizes, pure=library, ops=ops)
    return measure_batch("kernel", label, args, meta, copy_bps, library)


def measure_batch(phase, label, args, meta, copy_bps=None, library=False,
                  **extra):
    """``pred_filter_batch`` on ``args`` against its plain version: exact
    equality, CUDA-event times and the byte bound; one ``phase`` line."""
    from repro_torch.kernels.pred_filter import pred_filter_batch
    from repro_torch.kernels.pred_filter.ref import _batch_bool

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
    rows_alive = g_alive * args["block_rows"]
    nbytes = (ncols * 4 * rows_alive + meta["k"] * meta["n"]
              + 2 * 4 * (meta["a"] + meta["m"]) * meta["lo"].shape[1]
              + 4 * meta["k"] * (meta["a"] + 2 * meta["m"]) + 4 * meta["keys"]
              + 4 * (2 * meta["a"] + meta["m"]))
    iters = args.get("iters", 0)
    nops = meta["k"] * rows_alive * (meta["a"] + meta["m"] * (iters + 1))
    bound_ms = max(nbytes / HBM_BYTES_PER_S, nops / ALU_OPS_PER_S) * 1e3
    library_ms = k4_ms = None
    cold = {}
    if meta["m"] == 0 and meta["k"] == 1 and meta["a"] == 1:
        # one binding of one atom: a single PyTorch comparison computes it
        (ci, op), = args["atoms"]
        col, t = args["cols"][ci], int(args["thresholds"][0, 0])
        compare = TORCH_COMPARE[op]
        if not torch.equal(compare(col, t), want[0]):
            raise AssertionError(f"{label}: torch.{compare.__name__} disagrees")
        library_ms = time_ms(lambda: compare(col, t))
        cold = dict(ms_cold=time_ms_cold(lambda: pred_filter_batch(**args)),
                    library_ms_cold=time_ms_cold(lambda: compare(col, t)))
    if library:
        from repro_torch.kernels.membership.membership import launch_sorted

        col = args["cols"][args["set_cols"][0]]
        keys = args["set_slab"]
        lib = torch.isin(col, keys)
        if not torch.equal(lib, want[0]):
            raise AssertionError(f"{label}: torch.isin disagrees")
        library_ms = time_ms(lambda: torch.isin(col, keys), reps=20, inner=1)
        # K4's lock-step search on the same random keys and set: the
        # yardstick of a search without K2's zone phase and compares
        if not torch.equal(launch_sorted(col, keys).bool(), want[0]):
            raise AssertionError(f"{label}: the K4 kernel disagrees")
        k4_ms = time_ms(lambda: launch_sorted(col, keys))
    rec = dict(case=label, n=meta["n"], k=meta["k"], a=meta["a"], m=meta["m"],
               set_keys=meta["keys"], blocks_alive=int(g_alive),
               blocks=int(meta["lo"].shape[1]), max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_bytes=int(nbytes),
               bound_by="bytes" if nbytes / HBM_BYTES_PER_S
               >= nops / ALU_OPS_PER_S else "operations",
               bound_ms_copy=(nbytes / copy_bps * 1e3) if copy_bps else None,
               library_ms=library_ms, k4_kernel_ms=k4_ms, **cold, **extra)
    emit({"phase": phase, **rec})
    del got, want
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
def best_s(fn, reps: int = 10) -> float:
    """Least host seconds of ``reps`` calls of ``fn`` after one warm-up;
    every call here ends in a host mask (a device launch in its readback)."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def phase_device_ratio(smi: str, device: str = "cuda",
                       sizes=(1 << 21, 1 << 23)):
    """Marginal seconds per unit of cost-model work of each seeded route over
    the host numpy scan's per row x atom (``dispatch.host_row_cost``): the
    slope between two sizes, which the fixed costs cancel out of.  One line
    per route, each naming the ``core/cost.py`` constant it seeds:

    - ``device``: the launch path (cached slab, operand upload, kernel, mask
      readback) on 4 atoms — ``DEVICE_RATIO_CUDA``;
    - ``insitu``: host code-space compares on an encoded ``StoredTable``
      (two frame-of-reference columns, 2 atoms) — ``INSITU_RATIO``;
    - ``device_member``: a K2 launch of one ``IN`` atom through
      ``TorchBackend.scan`` — ``MEMBER_RATIO``;
    - ``insitu_rle``: one atom on an RLE column (runs of 32) through
      ``scan_stored`` on the card, work = runs + rows as the store charges
      it — ``RLE_RATIO``;
    - ``disk_insitu``: the ``insitu`` scan over the stage's memmapped
      payloads after ``demote`` (page cache warm) — ``DISK_RATIO``."""
    from repro_torch.core import dispatch
    from repro_torch.core.expr import Col, IsIn, ParamSet, land
    from repro_torch.core.scan import ScanEngine, ScanStats, TorchBackend
    from repro_torch.core.store import IntermediateStore
    from repro_torch.core.table import Table

    be = TorchBackend(device=device)
    rng = np.random.default_rng(3)
    a = 4
    slabs = {n: rng.integers(-1000, 1000, (a, n)).astype(np.int32) for n in sizes}
    thr = rng.integers(-1000, 1000, (1, a)).astype(np.int32)
    t = {n: best_s(lambda n=n: be._bench_launch(slabs[n], thr)) for n in sizes}
    del slabs
    slope = (t[sizes[1]] - t[sizes[0]]) / ((sizes[1] - sizes[0]) * a)
    rc = dispatch.host_row_cost()
    emit({"phase": "device_ratio", "device_s_per_row_atom": slope,
          "host_s_per_row_atom": rc, "ratio": slope / rc,
          "launch_s": {str(n): v for n, v in t.items()}})

    forced = TorchBackend(device=device, device_cutover=0)
    stats = ScanStats()
    forced.attach_stats(stats)
    compile_ = ScanEngine("numpy").compile
    p_insitu = compile_(land(Col("a") >= 100, Col("b") < 300))
    p_rle = compile_(Col("r") >= 500)
    p_member = compile_(IsIn(Col("a"), ParamSet("v")))
    member = {"v": rng.choice(1000, 256, replace=False).astype(np.int64)}
    times = {r: {} for r in ("insitu", "device_member", "insitu_rle",
                             "disk_insitu")}
    work = {r: {} for r in times}
    for n in sizes:
        tab = Table({"a": rng.integers(0, 1000, n),
                     "b": rng.integers(-500, 500, n),
                     "r": np.repeat(rng.integers(0, 1000, n // 32 + 1),
                                    32)[:n]}, {}, "ratio")
        store = IntermediateStore()
        try:
            st = store.put(1, tab)
            if (st.encodings() != {"a": "for", "b": "for", "r": "rle"}
                    or store._insitu_candidate(st, p_insitu)[0] != "insitu"):
                raise AssertionError(f"unexpected stage encodings "
                                     f"{st.encodings()}")
            times["insitu"][n] = best_s(lambda: store.backend.scan(p_insitu, st, {}))
            work["insitu"][n] = 2 * n
            fused0 = stats.member_fused_scans
            times["device_member"][n] = best_s(
                lambda: forced.scan(p_member, tab, member))
            if stats.member_fused_scans < fused0 + 11:
                raise AssertionError("device_member did not take K2")
            work["device_member"][n] = n
            times["insitu_rle"][n] = best_s(
                lambda: forced.scan_stored(p_rle, st, {}, force=True))
            work["insitu_rle"][n] = int(st.enc["r"].run_values.size) + n
            disk = store.demote(1)
            times["disk_insitu"][n] = best_s(
                lambda: store.backend.scan(p_insitu, disk, {}))
            work["disk_insitu"][n] = 2 * n
        finally:
            store.close()
        del tab
    constant = {"insitu": "INSITU_RATIO", "device_member": "MEMBER_RATIO",
                "insitu_rle": "RLE_RATIO", "disk_insitu": "DISK_RATIO"}
    out = {}
    for route, ts in times.items():
        w0, w1 = work[route][sizes[0]], work[route][sizes[1]]
        s = (ts[sizes[1]] - ts[sizes[0]]) / (w1 - w0)
        out[route] = s / rc
        emit({"phase": "route_ratio", "route": route, "constant": constant[route],
              "s_per_work": s, "host_s_per_row_atom": rc, "ratio": s / rc,
              "seconds": {str(n): v for n, v in ts.items()},
              "work": {str(n): v for n, v in work[route].items()},
              "nvidia_smi": smi})
    return out


# --------------------------------------------------------------------------- #
# phase 5: the main path
# --------------------------------------------------------------------------- #
def _answers_equal(a, b) -> bool:
    if sorted(a.lineage) != sorted(b.lineage) or a.precise != b.precise:
        return False
    return all(np.array_equal(np.sort(np.asarray(a.lineage[t])),
                              np.sort(np.asarray(b.lineage[t])))
               for t in a.lineage)


def drive(db, qname, engine=None, device=None, stage=None):
    """infer, run, query(0), query_batch(first 16 rows) with phase times;
    ``stage["name"]`` follows the call under way."""
    from repro_torch.core import PredTrace
    from repro_torch.tpch import ALL_QUERIES

    stage = {} if stage is None else stage
    plan = ALL_QUERIES[qname](db)
    pt = PredTrace(db, plan, scan_engine=engine, device=device)
    t = {}
    stage["name"] = "infer"
    t0 = time.perf_counter()
    pt.infer()
    t["infer_s"] = time.perf_counter() - t0
    stage["name"] = "run"
    t0 = time.perf_counter()
    pt.run()
    t["run_s"] = time.perf_counter() - t0
    n = pt.exec_result.output.nrows
    if n == 0:
        raise AssertionError(f"{qname}: empty output")
    stage["name"] = "query"
    t0 = time.perf_counter()
    one = pt.query(0)
    t["query_s"] = time.perf_counter() - t0
    rows = list(range(min(16, n)))
    stage["name"] = "query_batch"
    t0 = time.perf_counter()
    batch = pt.query_batch(rows)
    t["query_batch_s"] = time.perf_counter() - t0
    return pt, [one] + batch, t


def capture_batch_launches(calls: list, stage: dict):
    """Wraps the scan backend's ``pred_filter_batch`` so that each call
    keeps its operands (on the card) in ``calls``, with the query and stage
    under way; returns the function that unwraps it."""
    from repro_torch.core import scan

    real = scan.pred_filter_batch

    def recording(cols, thresholds, atoms, blk_lo, blk_hi, **kw):
        calls.append((dict(stage), dict(cols=cols, thresholds=thresholds,
                                        atoms=atoms, blk_lo=blk_lo,
                                        blk_hi=blk_hi, **kw)))
        return real(cols, thresholds, atoms, blk_lo, blk_hi, **kw)

    scan.pred_filter_batch = recording

    def unwrap():
        scan.pred_filter_batch = real
    return unwrap


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
    launches, calls, stage = {}, [], {}
    for route in ("forced", "auto"):
        unwrap = None
        if route == "forced":
            for k in CUTOVER_ENV:
                os.environ[k] = "0"
            unwrap = capture_batch_launches(calls, stage)
        reset_launches()
        stats = {}
        for q in ("q3", "q12"):
            stage["query"] = q
            pt, answers, t = drive(db, q, device="cuda", stage=stage)
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
        if unwrap is not None:
            unwrap()
        for k in CUTOVER_ENV:
            os.environ.pop(k, None)
    if launches["forced"]["cmp"] < 1 or launches["forced"]["sets"] < 1:
        raise AssertionError(f"forced main path missed a kernel variant: "
                             f"{launches['forced']}")
    n_forced = launches["forced"]["cmp"] + launches["forced"]["sets"]
    if len(calls) != n_forced:
        raise AssertionError(f"captured {len(calls)} calls of {n_forced} "
                             f"launches")
    return launches["forced"], db, calls


def launch_meta(args) -> dict:
    """The shape of one kept ``pred_filter_batch`` launch, as
    ``measure_batch`` takes it."""
    thr = args["thresholds"].cpu().numpy()
    m = len(args.get("set_cols", ()))
    return dict(n=int(args["cols"].shape[1]), k=thr.shape[0], a=thr.shape[1],
                m=m, lo=args["blk_lo"].cpu().numpy(),
                hi=args["blk_hi"].cpu().numpy(), thr=thr,
                keys=int(args["set_slab"].numel()) if m else 0)


def phase_main_path_kernels(calls) -> dict:
    """K1 and K2 on the operands the forced main path gave them, call by
    call, against the plain version (these launches come after the main
    path's counts were read).  Returns the records by variant."""
    recs = {"cmp": [], "sets": []}
    for i, (where, args) in enumerate(calls):
        meta = launch_meta(args)
        m = meta["m"]
        extra = dict(query=where["query"], stage=where["name"])
        if m:
            extra["set_len"] = args["set_len"].cpu().numpy().tolist()
        label = f"{'K2' if m else 'K1'} main path {where['query']} {where['name']} #{i}"
        recs["sets" if m else "cmp"].append(measure_batch(
            "main_path_kernel", label, args, meta, **extra))
    return recs


# --------------------------------------------------------------------------- #
# phase 7: the serving path over a disk-tiered store, with appends
# --------------------------------------------------------------------------- #
SERVE_QUERIES = ("q3", "q12")
# the workload of the reference's src/repro/launch/lineage_serve.py
SERVE = dict(requests=64, clients=4, burst=16, zipf=1.5, window_ms=3.0,
             max_batch=32)
# the append after which q3's cached answers must be extended, not recomputed
LATE_LINES = "late lineitems of existing orders"


def tally_method(cls, name: str, tally: dict, nbytes) -> callable:
    """Wraps ``cls.name`` so that each call adds one to ``tally["calls"]``,
    its seconds (after a device synchronise) to ``tally["seconds"]`` and
    ``nbytes(args, result)`` to ``tally["bytes"]``; returns the unwrapper."""
    real = getattr(cls, name)
    lock = threading.Lock()

    def timed(self, *a, **kw):
        t0 = time.perf_counter()
        out = real(self, *a, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        with lock:
            tally["calls"] += 1
            tally["seconds"] += dt
            tally["bytes"] += int(nbytes(a, out))
        return out

    setattr(cls, name, timed)
    return lambda: setattr(cls, name, real)


def new_tally() -> dict:
    return {"calls": 0, "seconds": 0.0, "bytes": 0}


def grown_catalog(cat, deltas):
    """The catalog with each delta's rows concatenated (row ids included):
    the oracle's appended catalog, built without the incremental path."""
    from repro_torch.core.table import Table

    out = dict(cat)
    for name, d in deltas.items():
        base = cat[name]
        out[name] = Table({c: np.concatenate([np.asarray(base.cols[c]),
                                              np.asarray(d.cols[c])])
                           for c in base.cols}, dict(base.dicts), base.name)
    return out


def late_lineitems(li, k: int, rng) -> dict:
    """``k`` lineitems added to existing orders: each copies a random
    lineitem's values and takes the next free ``l_linenumber`` of its order,
    so (l_orderkey, l_linenumber) stays TPC-H's unique lineitem key."""
    lk = np.asarray(li.cols["l_orderkey"])
    ln = np.asarray(li.cols["l_linenumber"])
    idx = rng.integers(0, li.nrows, k)
    keys, inv = np.unique(lk, return_inverse=True)
    top = np.zeros(len(keys), dtype=np.int64)
    np.maximum.at(top, inv, ln)
    # the j-th new line of an order (in draw order) gets its max + 1 + j
    g = inv[idx]
    order = np.argsort(g, kind="stable")
    first = np.searchsorted(g[order], g[order])
    rank = np.empty(k, dtype=np.int64)
    rank[order] = np.arange(k) - first
    cols = {c: np.asarray(li.cols[c])[idx] for c in li.columns}
    cols["l_linenumber"] = (top[g] + 1 + rank).astype(ln.dtype)
    return cols


def append_deltas(cat, rng):
    """Two appends, each encoded against the catalog it lands on
    (``encode_delta_like``): 1% new orders with their lineitems (copies of
    random orders under new order keys, like TPC-H's refresh function 1),
    then 1% more lineitems added to orders already there, each under its
    order's next line number.  Returns (label, deltas) pairs."""
    from repro_torch.core.table import encode_delta_like

    o, li = cat["orders"], cat["lineitem"]
    okeys = np.asarray(o.cols["o_orderkey"])
    pick = rng.choice(o.nrows, o.nrows // 100, replace=False)
    new_keys = (okeys.max() + 1 + np.arange(len(pick))).astype(okeys.dtype)
    ocols = {c: np.asarray(o.cols[c])[pick] for c in o.columns}
    ocols["o_orderkey"] = new_keys
    lk = np.asarray(li.cols["l_orderkey"])
    srt = np.argsort(okeys[pick])
    sel = np.flatnonzero(np.isin(lk, okeys[pick]))
    lcols = {c: np.asarray(li.cols[c])[sel] for c in li.columns}
    lcols["l_orderkey"] = new_keys[srt][np.searchsorted(okeys[pick][srt],
                                                        lk[sel])]
    rf1 = {"orders": encode_delta_like(o, ocols),
           "lineitem": encode_delta_like(li, lcols)}
    li1 = grown_catalog(cat, rf1)["lineitem"]
    late = {"lineitem": encode_delta_like(
        li1, late_lineitems(li1, li1.nrows // 100, rng))}
    return [("new orders with their lineitems", rf1),
            (LATE_LINES, late)]


def numpy_pipelines(cat, stack) -> dict:
    """q3 and q12 as numpy-backend PredTraces with a RAM store on ``cat``
    (closed with ``stack``), run."""
    from repro_torch.core import PredTrace, ScanEngine
    from repro_torch.tpch import ALL_QUERIES

    pts = {}
    for q in SERVE_QUERIES:
        pts[q] = stack.enter_context(PredTrace(
            dict(cat), ALL_QUERIES[q](cat), store=True,
            scan_engine=ScanEngine("numpy")))
        pts[q].infer()
        pts[q].run()
    return pts


def oracle_answers(pts, reqs) -> dict:
    """The numpy pipelines' answers by (pipeline, row)."""
    out = {}
    for q, pt in pts.items():
        rows = sorted({r for qq, r in reqs if qq == q})
        out.update({(q, r): a for r, a in zip(rows, pt.query_batch(rows))})
    return out


def serve_oracle(cat, reqs) -> dict:
    from contextlib import ExitStack

    with ExitStack() as stack:
        return oracle_answers(numpy_pipelines(cat, stack), reqs)


def check_served(answers, reqs, oracle, label) -> None:
    for (q, r), a in zip(reqs, answers):
        if not _answers_equal(a, oracle[(q, r)]):
            raise AssertionError(f"{label}: {q} row {r} differs from numpy")


def serve_stats(st) -> dict:
    keep = ("answered", "failed", "batches", "coalesce_width_avg",
            "coalesce_width_max", "cache_hit_rate", "cache_hits",
            "cache_misses", "cache_stale", "delta_hits", "disk_tier_answers",
            "superset_answers", "latency_ms_p50", "latency_ms_p99")
    out = {k: st[k] for k in keep}
    looked = st["cache_hits"] + st["cache_misses"]
    out["cache_stale_rate"] = st["cache_stale"] / looked if looked else 0.0
    return out


def route_counts(pts) -> dict:
    return {q: {k: getattr(pt.scan_engine.stats, k) for k in (
        "device_scans", "device_chosen", "rle_insitu_chosen",
        "disk_insitu_chosen", "decode_chosen", "member_fused_scans")} for q, pt in pts.items()}


# a stored stage's device routes (encoded lanes scanned by K1/K2 on the card)
DEVICE_STORE_ROUTES = ("device_insitu", "insitu_rle")
# engine counters bumped by exactly one store route each; a scan that moves
# none of them ran the host's zone-map candidate gather ("pruned", which
# scans partitions) or had its zone maps prune every partition ("no_work")
STORE_ROUTE_COUNTERS = {"device_chosen": "device_insitu",
                        "rle_insitu_chosen": "insitu_rle",
                        "disk_insitu_chosen": "disk_insitu",
                        "decode_chosen": "decode",
                        "insitu_chosen": "insitu"}


def pin_store_device_route() -> callable:
    """Forced run: a stored stage's scan ranks the store's device route
    first wherever it is offered (the cost model would otherwise learn to
    scan a demoted stage on the host); the other candidates stay behind it
    for a program the device cannot take.  Returns the unwrapper."""
    from repro_torch.core.cost import CostModel

    real = CostModel.choose

    def choose(self, site, cands, meta=None):
        ch = real(self, site, cands, meta)
        dev = [t for t in ch.ranked if t[1] in DEVICE_STORE_ROUTES]
        if site.startswith("store:") and dev and ch.route != dev[0][1]:
            ch.ranked = dev[:1] + [t for t in ch.ranked if t is not dev[0]]
            ch.est, ch.route, ch.work = dev[0]
            if ch.decision is not None:
                ch.decision.chosen, ch.decision.est_s = ch.route, ch.est
        return ch

    CostModel.choose = choose
    return lambda: setattr(CostModel, "choose", real)


def tally_store_routes(routes: dict, names: dict) -> callable:
    """Counts each stored-stage scan by (query, stage, tier, route) in
    ``routes``: the route is the store counter that the scan moved on its
    engine (``names`` maps an engine's id to its query).  Returns the
    unwrapper."""
    from repro_torch.core.store import IntermediateStore

    real = IntermediateStore.scan
    lock = threading.Lock()

    def scan(self, node_id, pred, binding, engine):
        tier = self.stages[node_id].tier
        keys = (*STORE_ROUTE_COUNTERS, "partitions_scanned")
        before = {k: getattr(engine.stats, k) for k in keys}
        out = real(self, node_id, pred, binding, engine)
        moved = [r for k, r in STORE_ROUTE_COUNTERS.items()
                 if getattr(engine.stats, k) != before[k]]
        if not moved:
            moved = ["pruned" if engine.stats.partitions_scanned
                     != before["partitions_scanned"] else "no_work"]
        key = f"{names.get(id(engine), '?')} stage {node_id} {tier} {moved[0]}"
        with lock:
            routes[key] = routes.get(key, 0) + 1
        return out

    IntermediateStore.scan = scan
    return lambda: setattr(IntermediateStore, "scan", real)


def check_disk_scans_on_card(routes: dict) -> None:
    """Forced run: every scan of a demoted stage ran a device route, and at
    least one did."""
    disk = {k: v for k, v in routes.items()
            if " disk " in k and not k.endswith("no_work")}
    host = {k: v for k, v in disk.items()
            if not k.endswith(DEVICE_STORE_ROUTES)}
    if host or not disk:
        raise AssertionError(f"demoted stages not scanned on the card: "
                             f"{routes}")


def phase_serve(db, smi: str):
    """Phase 7: TPC-H q3 and q12 at phase 5's scale through the serving
    path.  Each pipeline keeps no stage in RAM and every materialized stage
    on the disk tier; LineageService answers the workload of
    ``launch/lineage_serve.py``, once with the device cutovers forced to 0
    and once auto-routed, every answer held to a numpy-backend PredTrace
    with a RAM store on the same catalog.  The forced run then appends
    twice (``run_delta``) and serves the same requests again, held to a
    fresh numpy PredTrace over the appended catalog.  K1/K2 launches of
    the forced run are counted from 0, kept and replayed against the plain
    version afterwards."""
    from contextlib import ExitStack

    from repro_torch.core import LineageService, PredTrace
    from repro_torch.core.dispatch import disk_scan_probe
    from repro_torch.core.scan import TorchBackend
    from repro_torch.core.store import IntermediateStore
    from repro_torch.kernels.pred_filter import LAUNCHES, reset_launches
    from repro_torch.launch.lineage_serve import serve, workload
    from repro_torch.tpch import ALL_QUERIES

    t_phase = time.perf_counter()
    probe = disk_scan_probe()
    emit({"phase": "serve_disk_probe", "cutover_rows": int(probe.value),
          "source": probe.source, "nvidia_smi": smi})
    cat0 = dict(db)
    t0 = time.perf_counter()
    with ExitStack() as stack:
        npts = numpy_pipelines(cat0, stack)
        reqs = workload(npts, SERVE["requests"], SERVE["zipf"], seed=1)
        # lone requests (a batch of one each): answered by query(), whose
        # stage scan takes the store's in-situ routes on the disk tier
        lone = [(q, r) for q in SERVE_QUERIES for r in [
            r for r in range(npts[q].exec_result.output.nrows)
            if (q, r) not in set(reqs)][:2]]
        oracle0 = oracle_answers(npts, reqs + lone)
    emit({"phase": "serve_oracle", "seconds": time.perf_counter() - t0,
          "requests": len(reqs), "distinct": len(set(reqs))})
    calls, stage = [], {}
    launches = None
    for route in ("forced", "auto"):
        unwrap, routes, names = [], {}, {}
        if route == "forced":
            for k in CUTOVER_ENV:
                os.environ[k] = "0"
            unwrap.append(capture_batch_launches(calls, stage))
            unwrap.append(pin_store_device_route())
            reset_launches()
        unwrap.append(tally_store_routes(routes, names))
        demote, upload = new_tally(), new_tally()
        unwrap.append(tally_method(IntermediateStore, "demote", demote,
                                   lambda a, out: out.nbytes()))
        unwrap.append(tally_method(TorchBackend, "_build_entry", upload,
                                   lambda a, out: a[0].nbytes))
        try:
            with ExitStack() as stack:
                pts = {}
                t0 = time.perf_counter()
                for q in SERVE_QUERIES:
                    stage.update(query=q, name="build")
                    pt = stack.enter_context(PredTrace(
                        dict(cat0), ALL_QUERIES[q](cat0), store=True,
                        budget_bytes=0, disk_budget_bytes=None,
                        device="cuda"))
                    names[id(pt.scan_engine)] = q
                    pt.infer()
                    pt.run()
                    if sorted(pt.store.disk_stages()) != sorted(pt.mat_plan.disk) \
                            or not pt.mat_plan.disk or pt.mat_plan.dropped:
                        raise AssertionError(f"{q}: stages not demoted")
                    pts[q] = pt
                emit({"phase": "serve_build", "route": route,
                      "seconds": time.perf_counter() - t0,
                      "stages_demoted": demote["calls"],
                      "demoted_bytes": demote["bytes"],
                      "demote_seconds": demote["seconds"],
                      "disk_stages": {q: len(pt.store.disk_stages())
                                      for q, pt in pts.items()},
                      "slab_uploads": dict(upload), "nvidia_smi": smi})
                svc = stack.enter_context(LineageService(
                    pts, max_batch=SERVE["max_batch"],
                    window_s=SERVE["window_ms"] / 1e3))
                rounds = [("initial", None)]
                if route == "forced":
                    rounds += append_deltas(cat0, np.random.default_rng(15))
                cat, oracle = cat0, oracle0
                for label, deltas in rounds:
                    rec = {"phase": "serve", "route": route, "round": label}
                    hits0 = svc.stats()["delta_hits"]
                    upload.update(new_tally())
                    demote.update(new_tally())
                    if deltas is not None:
                        t0 = time.perf_counter()
                        for q, pt in pts.items():
                            stage.update(query=q, name=f"run_delta: {label}")
                            rep = pt.run_delta(deltas).delta.to_dict()
                            rec.setdefault("delta_reports", {})[q] = {
                                "output_action": rep["output_action"],
                                "full_invalidation": rep["full_invalidation"],
                                "stages": [s["action"] for s in
                                           rep["stages"].values()],
                                "seconds": rep["seconds"]}
                        rec["run_delta_s"] = time.perf_counter() - t0
                        rec["appended_rows"] = {n: int(d.nrows)
                                                for n, d in deltas.items()}
                        cat = grown_catalog(cat, deltas)
                        t0 = time.perf_counter()
                        oracle = serve_oracle(cat, reqs + lone)
                        rec["oracle_s"] = time.perf_counter() - t0
                    stage.update(query="served", name=f"serve: {label}")
                    t0 = time.perf_counter()
                    answers = serve(svc, reqs, SERVE["clients"],
                                    SERVE["burst"])
                    rec["serve_s"] = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    lone_answers = [svc.query(r, q, timeout=300) for q, r in lone]
                    rec["lone_s"] = time.perf_counter() - t0
                    st = svc.stats()
                    check_served(answers, reqs, oracle, f"{route} {label}")
                    check_served(lone_answers, lone, oracle,
                                 f"{route} {label} lone")
                    if st["failed"] or st["answered"] % (len(reqs) + len(lone)):
                        raise AssertionError(f"{route} {label}: {st}")
                    if st["disk_tier_answers"] < 1:
                        raise AssertionError(f"{route} {label}: no answer "
                                             f"from the disk tier")
                    rec.update(identical_to_numpy=True, stats=serve_stats(st),
                               routes=route_counts(pts),
                               stage_routes=dict(routes),
                               slab_uploads=dict(upload), demotes=dict(demote),
                               nvidia_smi=smi)
                    emit(rec)
                    if label == LATE_LINES and st["delta_hits"] <= hits0:
                        raise AssertionError("no delta hit after an append "
                                             "that keeps q3's stage")
        finally:
            for u in reversed(unwrap):
                u()
            for k in CUTOVER_ENV:
                os.environ.pop(k, None)
        if route == "forced":
            launches = {k: LAUNCHES[k] for k in ("cmp", "sets")}
            emit({"phase": "serve_launches", "route": route,
                  "launches": launches, "captured": len(calls),
                  "stage_routes": routes})
            check_disk_scans_on_card(routes)
    if launches["cmp"] < 1 or launches["sets"] < 1:
        raise AssertionError(f"serving path missed a kernel variant: {launches}")
    if len(calls) != launches["cmp"] + launches["sets"]:
        raise AssertionError(f"captured {len(calls)} calls of {launches}")
    replay_launches(calls, "serve", lambda where, args: (variant(args),))
    emit({"phase": "serve_total", "seconds": time.perf_counter() - t_phase})


def replay_launches(calls, phase: str, group) -> dict:
    """Every kept launch against the plain version (exact equality), then
    the largest launch of each group (``group(where, args)``, a tuple of
    names) timed beside its bound: one ``{phase}_replay`` line and one
    ``{phase}_kernel`` line per group.  Returns those records by group."""
    from repro_torch.kernels.pred_filter import pred_filter_batch
    from repro_torch.kernels.pred_filter.ref import _batch_bool

    largest = {}
    for i, (where, args) in enumerate(calls):
        got = pred_filter_batch(**args)
        want = _batch_bool(args["cols"], args["thresholds"], args["atoms"],
                           args.get("set_cols", ()), args.get("set_slab"),
                           args.get("set_off"), args.get("set_len"),
                           args.get("iters", 1))
        if not torch.equal(got, want):
            raise AssertionError(f"{phase} launch #{i} ({where}) differs from "
                                 f"its plain version")
        key = group(where, args)
        size = args["thresholds"].shape[0] * args["cols"].shape[1]
        if size > largest.get(key, (-1,))[0]:
            largest[key] = (size, i)
    emit({"phase": f"{phase}_replay", "launches_checked": len(calls),
          "all_equal": True})
    recs = {}
    for key, (_, i) in sorted(largest.items()):
        where, args = calls[i]
        meta = launch_meta(args)
        extra = {k: where[k] for k in ("run", "route") if k in where}
        label = (f"{'K2' if meta['m'] else 'K1'} {phase} largest "
                 f"{' '.join(key)} launch {where['query']} "
                 f"{where.get('run', '')} {where['name']} #{i}")
        recs[key] = measure_batch(f"{phase}_kernel", label, args, meta,
                                  query=where["query"], stage=where["name"],
                                  **extra)
    return recs


def variant(args) -> str:
    return "sets" if args.get("set_cols") else "cmp"


# --------------------------------------------------------------------------- #
# phase 8: the partition runtime (pool, device carry, mesh shards)
# --------------------------------------------------------------------------- #
# the card of phases 8 and 9 (a mesh names it as "cuda:0")
CARD = "cuda"
PARTITION_QUERIES = ("q3", "q12")
PARTITION_ROWS = (0, 1, 2, 3)
PARTITION_COUNTERS = ("scans", "device_scans", "member_fused_scans",
                      "partitions_scanned", "partitions_pruned",
                      "fanout_scans", "carry_refused")


def label_partition_routes(stage: dict, pin_carry: bool) -> callable:
    """Marks ``stage["route"]`` while the partition executor works, so each
    captured launch names its route: ``shard`` (a mesh shard's scan),
    ``carry`` (a partitioned scan launched over the whole table),
    ``partitioned`` (surviving partitions scanned as slices); launches
    outside the executor keep ``engine``.  With ``pin_carry`` the carry is
    taken wherever the kernel can take the program (the forced run), not
    only where the cost model prefers it.  Returns the unwrapper."""
    from repro_torch.core.distributed import PartitionExecutor
    from repro_torch.core.scan import TorchBackend

    real = {"dev": PartitionExecutor._device_scan,
            "fan": PartitionExecutor._fanout_scan,
            "carry": TorchBackend.fused_carry_ok}

    def scoped(fn, label):
        def run(self, *a, **kw):
            prev, stage["route"] = stage.get("route"), label
            try:
                return fn(self, *a, **kw)
            finally:
                stage["route"] = prev
        return run

    def carry(self, prog, table, binding, surviving_rows=None):
        if pin_carry:
            ok = bool(prog.cmp_atoms) and bool(
                self._split_cmp(prog, table, binding)[0])
        else:
            ok = real["carry"](self, prog, table, binding, surviving_rows)
        if ok:
            stage["route"] = "carry"
        return ok

    PartitionExecutor._device_scan = scoped(real["dev"], "shard")
    PartitionExecutor._fanout_scan = scoped(real["fan"], "partitioned")
    TorchBackend.fused_carry_ok = carry

    def unwrap():
        PartitionExecutor._device_scan = real["dev"]
        PartitionExecutor._fanout_scan = real["fan"]
        TorchBackend.fused_carry_ok = real["carry"]
    return unwrap


def track_slab_builds(keys: list, upload: dict) -> callable:
    """Records (backend, table, columns) of every slab the torch backend
    builds and uploads (``_slab_entry`` calls that reached ``_build_entry``,
    whose calls and bytes ``upload`` tallies).  Returns the unwrapper."""
    from repro_torch.core.scan import TorchBackend
    from repro_torch.core.table import table_uid

    unwrap_build = tally_method(TorchBackend, "_build_entry", upload,
                                lambda a, out: a[0].nbytes)
    real = TorchBackend._slab_entry

    def entry(self, table, cols):
        before = upload["calls"]
        out = real(self, table, cols)
        if upload["calls"] != before:
            keys.append((id(self), table_uid(table), tuple(cols)))
        return out

    TorchBackend._slab_entry = entry

    def unwrap():
        TorchBackend._slab_entry = real
        unwrap_build()
    return unwrap


def check_answers(got, want, label) -> None:
    if len(got) != len(want) or not all(
            _answers_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{label}: answers differ from numpy")


def partition_oracle(db) -> dict:
    """Unpartitioned numpy-backend PredTrace answers of rows 0-3 by query:
    query, query_batch, query_iterative, and the iterative plan with each
    row's binding for ``distributed_refine``."""
    from repro_torch.core import PredTrace, ScanEngine
    from repro_torch.tpch import ALL_QUERIES

    out = {}
    for q in PARTITION_QUERIES:
        pt = PredTrace(db, ALL_QUERIES[q](db), scan_engine=ScanEngine("numpy"))
        pt.infer()
        pt.run()
        rows = [r for r in PARTITION_ROWS if r < pt.exec_result.output.nrows]
        rec = {"rows": rows,
               "query": [pt.query(r) for r in rows],
               "query_batch": pt.query_batch(rows),
               "query_iterative": [pt.query_iterative(r) for r in rows]}
        rec["iter_plan"] = pt.iter_plan
        rec["bindings"] = [pt._output_binding(r, pt.iter_plan.out_params)
                           for r in rows]
        out[q] = rec
        pt.close()
    return out


def drive_partitioned(db, q, oracle, stage, **kw) -> dict:
    """A ``PredTrace(device=CARD, **kw)`` of ``q``: run, then rows 0-3
    through query, query_batch and query_iterative, each call timed and
    every answer held to the numpy oracle.  Returns the call times and the
    engine's counters."""
    from repro_torch.core import PredTrace
    from repro_torch.tpch import ALL_QUERIES

    ref = oracle[q]
    rows = ref["rows"]
    secs = {}
    with PredTrace(db, ALL_QUERIES[q](db), device=CARD, **kw) as pt:
        for name, call in (("infer", pt.infer), ("run", pt.run)):
            stage["name"] = name
            t0 = time.perf_counter()
            call()
            secs[f"{name}_s"] = time.perf_counter() - t0
        got = {}
        for name in ("query", "query_batch", "query_iterative"):
            stage["name"] = name
            t0 = time.perf_counter()
            if name == "query_batch":
                got[name] = pt.query_batch(rows)
            else:
                got[name] = [getattr(pt, name)(r) for r in rows]
            secs[f"{name}_s"] = time.perf_counter() - t0
            check_answers(got[name], ref[name], f"{q} {kw} {name}")
        st = pt.scan_engine.stats
        counters = {k: getattr(st, k) for k in PARTITION_COUNTERS}
        cutover = None
        if pt.partition_exec is not None and pt.partition_exec.mesh is None:
            cutover = pt.partition_exec.min_parallel_rows
    return {"seconds": secs, "counters": counters,
            "parallel_cutover_rows": cutover}


def drive_refine(db, q, oracle, stage, mesh, num_partitions=None) -> dict:
    """``distributed_refine`` of rows 0-3 over ``mesh`` on one engine,
    each answer held to the numpy oracle's ``query_iterative``."""
    from repro_torch.core import ScanEngine, distributed_refine

    ref = oracle[q]
    eng = ScanEngine("torch", device=CARD)
    secs, iters = [], []
    for r, binding, want in zip(ref["rows"], ref["bindings"],
                                ref["query_iterative"]):
        stage["name"] = f"distributed_refine row {r}"
        t0 = time.perf_counter()
        ans = distributed_refine(ref["iter_plan"], db, binding, mesh=mesh,
                                 engine=eng, num_partitions=num_partitions)
        secs.append(time.perf_counter() - t0)
        iters.append(ans.detail["iterations"])
        if sorted(ans.lineage) != sorted(want.lineage) or not all(
                np.array_equal(np.sort(ans.lineage[t]), np.sort(want.lineage[t]))
                for t in want.lineage):
            raise AssertionError(f"{q} distributed_refine {mesh} row {r} "
                                 f"differs from numpy")
    st = eng.stats
    return {"seconds": {"distributed_refine_s": secs}, "iterations": iters,
            "counters": {k: getattr(st, k) for k in PARTITION_COUNTERS}}


def phase_partition(db, smi: str) -> None:
    """Phase 8: q3 and q12 at phase 5's scale through the partition
    runtime, every answer identical to an unpartitioned numpy-backend
    PredTrace.  Runs: ``num_partitions=64, parallel=4`` forced (cutovers 0,
    the carry taken wherever the kernel can take the program) and
    auto-routed; ``mesh=("cuda:0",)``; ``distributed_refine`` over
    ``("cuda:0",)`` with and without 64 partitions and over
    ``("cuda:0", "cuda:0")``.  Every K1/K2 launch is kept with its route
    (carry, shard, partitioned, engine) and replayed against the plain
    version afterwards."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    oracle = partition_oracle(db)
    emit({"phase": "partition_oracle", "seconds": time.perf_counter() - t0,
          "rows": {q: o["rows"] for q, o in oracle.items()}})
    runs = [
        ("parallel forced", True, {"num_partitions": 64, "parallel": 4}),
        ("parallel auto", False, {"num_partitions": 64, "parallel": 4}),
        ("mesh cuda:0", False, {"mesh": (f"{CARD}:0",)}),
        ("distributed_refine cuda:0", False, {"refine_mesh": (f"{CARD}:0",)}),
        ("distributed_refine cuda:0 64 partitions", False,
         {"refine_mesh": (f"{CARD}:0",), "num_partitions": 64}),
        ("distributed_refine cuda:0 x2", False,
         {"refine_mesh": (f"{CARD}:0", f"{CARD}:0")}),
    ]
    calls, stage = [], {}
    for label, forced, kw in runs:
        kw = dict(kw)
        refine_mesh = kw.pop("refine_mesh", None)
        sharded = refine_mesh is not None or "mesh" in kw
        for q in PARTITION_QUERIES:
            unwrap = []
            if forced:
                for k in CUTOVER_ENV:
                    os.environ[k] = "0"
            start = len(calls)
            stage.update(query=q, run=label, route="engine")
            keys, upload = [], new_tally()
            unwrap.append(capture_batch_launches(calls, stage))
            unwrap.append(label_partition_routes(stage, pin_carry=forced))
            unwrap.append(track_slab_builds(keys, upload))
            try:
                if refine_mesh is not None:
                    rec = drive_refine(db, q, oracle, stage, refine_mesh,
                                       kw.get("num_partitions"))
                else:
                    rec = drive_partitioned(db, q, oracle, stage, **kw)
            finally:
                for u in reversed(unwrap):
                    u()
                for k in CUTOVER_ENV:
                    os.environ.pop(k, None)
            by_route = {}
            for where, args in calls[start:]:
                key = f"{where['route']} {variant(args)}"
                by_route[key] = by_route.get(key, 0) + 1
            repeats = len(keys) - len(set(keys))
            emit({"phase": "partition", "run": label, "query": q,
                  "identical_to_numpy": True, "launches": by_route,
                  **rec, "slab_uploads": dict(upload),
                  "slab_rebuilds": repeats, "nvidia_smi": smi})
            if rec.get("parallel_cutover_rows") is not None and not forced:
                emit({"phase": "partition_parallel_cutover", "workers": 4,
                      "cutover_rows": rec["parallel_cutover_rows"],
                      "query": q})
            if sharded and not any(k.startswith("shard") for k in by_route):
                raise AssertionError(f"{label} {q}: no shard launch")
            if sharded and repeats:
                raise AssertionError(f"{label} {q}: {repeats} shard slabs "
                                     f"uploaded again")
            if forced and not any(k.startswith("carry") for k in by_route):
                raise AssertionError(f"{label} {q}: no carried launch")
    replay_launches(calls, "partition",
                    lambda where, args: (where["route"], variant(args)))
    emit({"phase": "partition_total", "seconds": time.perf_counter() - t_phase})


# --------------------------------------------------------------------------- #
# phase 9: the paper's lazy baselines
# --------------------------------------------------------------------------- #
BASELINE_QUERIES = ("q3", "q12")


def phase_baselines(db, smi: str) -> None:
    """Phase 9: the paper's comparison at phase 5's scale.  The coverage
    profile over the 22 TPC-H queries (PredTrace infers every one; Trace
    and Panda say which they support), then for q3 and q12 the time of
    PredTrace's ``query(0)`` on the card against each baseline that
    supports the query (its ``prepare``, then its ``query``), every answer
    equal to the eager oracle ``oracle_lineage_for_values``.  A baseline
    that gives up (``Unsupported``: GProM's witness budget) is printed as
    such."""
    from repro_torch.core import (PredTrace, ScanEngine,
                                  oracle_lineage_for_values)
    from repro_torch.core.baselines import (PandaBaseline, RewriteBaseline,
                                            TraceBaseline, Unsupported)
    from repro_torch.core.executor import Executor
    from repro_torch.tpch import ALL_QUERIES

    t_phase = time.perf_counter()
    inferred, trace, panda = [], [], []
    for q, qf in ALL_QUERIES.items():
        plan = qf(db)
        PredTrace(db, plan, device=CARD).infer()
        inferred.append(q)
        if TraceBaseline(db, plan).supports():
            trace.append(q)
        if PandaBaseline(db, plan).supports():
            panda.append(q)
    emit({"phase": "baseline_coverage", "queries": len(ALL_QUERIES),
          "predtrace": len(inferred), "trace": len(trace),
          "panda": len(panda), "trace_queries": trace,
          "panda_queries": sorted(panda)})
    if (len(inferred), len(trace), sorted(panda)) != (
            22, 12, ["q1", "q10", "q3", "q5", "q6"]):
        raise AssertionError("coverage profile is not 22 / 12 / 5")

    def sets(lin):
        return {t: np.unique(np.asarray(list(v) if isinstance(v, frozenset)
                                        else v)) for t, v in lin.items()
                if len(v)}

    def same(a, b):
        return sorted(a) == sorted(b) and all(np.array_equal(a[t], b[t])
                                              for t in a)

    for q in BASELINE_QUERIES:
        plan = ALL_QUERIES[q](db)
        out = Executor(db, scan_engine=ScanEngine("numpy")).run(plan).output
        values = {c: out.cols[c][0] for c in out.columns}
        t0 = time.perf_counter()
        oracle = sets(oracle_lineage_for_values(db, plan, values))
        rec = {"phase": "baseline", "query": q, "row": 0,
               "oracle_s": time.perf_counter() - t0, "nvidia_smi": smi}
        with PredTrace(db, plan, device=CARD) as pt:
            t0 = time.perf_counter()
            pt.infer()
            pt.run()
            rec["predtrace_prepare_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            ans = pt.query(0)
            rec["predtrace_query_s"] = time.perf_counter() - t0
            if not same(sets(ans.lineage), oracle):
                raise AssertionError(f"PredTrace {q} differs from the oracle")
        for cls in (TraceBaseline, RewriteBaseline, PandaBaseline):
            b = cls(db, plan)
            if not b.supports():
                rec[b.name] = "unsupported"
                continue
            t0 = time.perf_counter()
            b.prepare()
            prep = time.perf_counter() - t0
            t0 = time.perf_counter()
            try:
                got = b.query(out, 0)
            except Unsupported as e:
                rec[b.name] = {"prepare_s": prep, "unsupported": str(e)}
                continue
            secs = time.perf_counter() - t0
            if not same(sets(got.lineage), oracle):
                raise AssertionError(f"{b.name} {q} differs from the oracle")
            rec[b.name] = {"prepare_s": prep, "query_s": secs,
                           "over_predtrace": secs / rec["predtrace_query_s"]}
        rec["identical_to_oracle"] = True
        emit(rec)
    emit({"phase": "baselines_total", "seconds": time.perf_counter() - t_phase})


# --------------------------------------------------------------------------- #
# phase 6: the other kernels through their entry points
# --------------------------------------------------------------------------- #
def reset_all_launches() -> None:
    from repro_torch.kernels import flash_attn, membership, pred_filter, rmsnorm

    for mod in (pred_filter, membership, flash_attn, rmsnorm):
        mod.reset_launches()


def all_launches() -> dict:
    from repro_torch.kernels import flash_attn, membership, pred_filter

    return {**pred_filter.LAUNCHES, **membership.LAUNCHES,
            **flash_attn.LAUNCHES}


def entry_inputs(db, seed: int = 6):
    """The phase's inputs: lineitem's q6 slab, its order keys and three key
    sets, and per attention case q, k, v ``[1, S, H, D]`` on the card."""
    from repro_torch.core.expr import Col, land
    from repro_torch.tpch import ALL_QUERIES

    li, orders = db["lineitem"], db["orders"]
    rng = np.random.default_rng(seed)
    okeys = np.asarray(orders.cols["o_orderkey"], np.int32)
    inp = {
        "cols": np.stack([li.cols["l_shipdate"],
                          li.cols["l_quantity"]]).astype(np.int32),
        "order": {"l_shipdate": 0, "l_quantity": 1},
        "q6_int": land(Col("l_shipdate") >= 19940101,
                       Col("l_shipdate") < 19950101, Col("l_quantity") < 24),
        # q6's whole filter: its l_discount bounds are non-integer floats
        "q6_whole": ALL_QUERIES["q6"](db).child.pred,
        "values": np.asarray(li.cols["l_orderkey"], np.int32),
        "sets": {
            "5k": rng.choice(okeys, 5_000, replace=False),
            "65536": rng.choice(okeys, 65_536, replace=False),
            "q3 orders": okeys[np.asarray(orders.cols["o_orderdate"]) < 19950315],
        },
    }
    gen = torch.Generator(device="cuda").manual_seed(seed)
    inp["attn"] = [
        tuple(torch.randn((1, s, h, d), generator=gen, device="cuda").to(
            getattr(torch, dt)) for _ in range(3))
        for _, _, dt, s, h, d, _ in ATTN_CASES]
    return inp


def drive_entry_points(inp) -> tuple:
    """One call of each entry point, launch counts at 0 just before and read
    just after; returns (outputs, launches, seconds per call)."""
    from repro_torch.kernels.flash_attn import mha_flash
    from repro_torch.kernels.membership import LAUNCHES as MB, probe
    from repro_torch.kernels.pred_filter import compile_conjunction, scan_mask

    order_whole = {**inp["order"], "l_discount": 2}
    if compile_conjunction(inp["q6_whole"], order_whole, {}) is not None:
        raise AssertionError("q6's whole predicate must not compile")
    torch.cuda.synchronize()
    reset_all_launches()
    out, secs = {}, {}
    t0 = time.perf_counter()
    out["scan_mask"] = scan_mask(inp["cols"], inp["q6_int"], inp["order"], {})
    secs["scan_mask"] = time.perf_counter() - t0
    whole = scan_mask(np.zeros((3, 1024), np.int32), inp["q6_whole"],
                      order_whole, {})
    if whole is not None:
        raise AssertionError("scan_mask of q6's whole predicate must be None")
    for name, vset in inp["sets"].items():
        before = MB["membership"]
        t0 = time.perf_counter()
        out[f"probe {name}"] = probe(inp["values"], vset)
        secs[f"probe {name}"] = time.perf_counter() - t0
        if MB["membership"] != before + 1:
            raise AssertionError(f"probe {name} did not launch the kernel")
    for (name, _, dt, s, h, d, window), (q, k, v) in zip(ATTN_CASES,
                                                         inp["attn"]):
        t0 = time.perf_counter()
        out[f"mha_flash {name} {dt}"] = mha_flash(q, k, v, window=window)
        torch.cuda.synchronize()
        secs[f"mha_flash {name} {dt}"] = time.perf_counter() - t0
    launches = all_launches()
    for key in ("single", "membership", "flash_attention"):
        if launches[key] < 1:
            raise AssertionError(f"entry points missed the {key} kernel: "
                                 f"{launches}")
    return out, launches, secs


def limit_share(got, want, q, k, v, window, median=False):
    """Worst ``|got - want| / attention_limit`` over the elements of folded
    ``[BH, S, D]`` tensors; the kernel passes when it is at most 1.  With
    ``median``: (worst, median) share."""
    from repro_torch.kernels.flash_attn import attention_limit

    lim = attention_limit(q, k, v, want, window=window)
    share = (got.float() - want.float()).abs() / lim
    del lim
    worst = float(share.max())
    return (worst, float(share.median())) if median else worst


def check_entry_outputs(inp, out) -> None:
    """Each entry point's answer: the numpy mask of q6's atoms,
    ``torch.isin`` for the probes, the plain attention within its limit."""
    from repro_torch.kernels.flash_attn import attention_ref
    from repro_torch.kernels.flash_attn.ops import _fold as fold

    c = inp["cols"]
    want = (c[0] >= 19940101) & (c[0] < 19950101) & (c[1] < 24)
    if not np.array_equal(out["scan_mask"], want):
        raise AssertionError("scan_mask differs from the numpy mask")
    vals = torch.from_numpy(inp["values"]).cuda()
    for name, vset in inp["sets"].items():
        lib = torch.isin(vals, torch.from_numpy(vset).cuda()).cpu().numpy()
        if not np.array_equal(out[f"probe {name}"], lib):
            raise AssertionError(f"probe {name} differs from torch.isin")
    for (name, _, dt, _, _, _, window), (q, k, v) in zip(ATTN_CASES,
                                                          inp["attn"]):
        got = out[f"mha_flash {name} {dt}"]
        if got.shape != q.shape or not torch.isfinite(got.float()).all():
            raise AssertionError(f"mha_flash {name}: bad shape or values")
        qf, kf, vf = fold(q), fold(k), fold(v)
        want = attention_ref(qf, kf, vf, window=window)
        if limit_share(fold(got), want, qf, kf, vf, window) > 1:
            raise AssertionError(f"mha_flash {name} {dt} differs from the "
                                 f"plain attention")
        del want
    torch.cuda.empty_cache()


def case_record(label, got, want, ms, plain_ms, nbytes, nops, ops_per_s,
                library_ms=None, phase="entry_kernel", **extra):
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = nops / ops_per_s * 1e3
    err = float((got.float() - want.float()).abs().max().item())
    rec = dict(case=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=max(bound_bytes_ms, bound_ops_ms),
               bound_by="bytes" if bound_bytes_ms >= bound_ops_ms
               else "operations", bound_bytes=int(nbytes), bound_ops=int(nops),
               library_ms=library_ms, **extra)
    emit({"phase": phase, **rec})
    return rec


def phase_entry_kernels(inp, secs, smi: str) -> dict:
    """Each kernel against its plain version on the entry points' inputs,
    with CUDA-event times, and K5's backward kernel on each attention case's
    operands; launches here are not counted."""
    from repro_torch.kernels.flash_attn import (BF16_RMS_LIMIT,
                                                attention_bf16_scores,
                                                attention_pairs, attention_ref,
                                                flash_attention, rms_ratio)
    from repro_torch.kernels.flash_attn.ops import _fold as fold
    from repro_torch.kernels.membership import membership_ref
    from repro_torch.kernels.membership.membership import launch_sorted
    from repro_torch.kernels.pred_filter import (compile_conjunction,
                                                 pred_filter, pred_filter_ref)

    recs = {"single": [], "membership": [], "flash_attention": [],
            "flash_attention_backward": []}
    # K3: q6's int32 atoms over the padded lineitem slab
    atoms, thr = compile_conjunction(inp["q6_int"], inp["order"], {})
    c = inp["cols"]
    slab = torch.from_numpy(np.pad(c, ((0, 0), (0, (-c.shape[1]) % 1024)))).cuda()
    thr_d = torch.from_numpy(thr).cuda()
    got = pred_filter(slab, thr_d, atoms)
    want = pred_filter_ref(slab, thr_d, atoms)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K3: kernel differs from its plain version")
    n = slab.shape[1]
    recs["single"].append(case_record(
        f"K3 scan_mask q6 atoms, n={n}", got, want,
        time_ms(lambda: pred_filter(slab, thr_d, atoms)),
        time_ms(lambda: pred_filter_ref(slab, thr_d, atoms), inner=1),
        nbytes=4 * 2 * n + 4 * n + 4 * 3 * len(atoms), nops=len(atoms) * n,
        ops_per_s=ALU_OPS_PER_S, entry_s=secs["scan_mask"]))
    del slab, got, want
    # K4: l_orderkey against each set, sorted and de-duplicated as probe
    # hands them to the kernel
    vals = torch.from_numpy(inp["values"]).cuda()
    for name, vset in inp["sets"].items():
        keys = torch.from_numpy(np.unique(vset)).cuda()
        got = launch_sorted(vals, keys)
        want = membership_ref(vals, keys)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K4 {name}: kernel differs from its plain version")
        n, m = vals.numel(), keys.numel()
        recs["membership"].append(case_record(
            f"K4 probe l_orderkey in {name} ({m} keys), n={n}", got, want,
            time_ms(lambda: launch_sorted(vals, keys)),
            time_ms(lambda: membership_ref(vals, keys), inner=1),
            nbytes=4 * n + 4 * m + 4 * n, nops=n * (m.bit_length() + 1),
            ops_per_s=ALU_OPS_PER_S,
            library_ms=time_ms(lambda: torch.isin(vals, keys), inner=1),
            set_keys=m, values="l_orderkey", entry_s=secs[f"probe {name}"]))
    # K4 on random values: K2's pure-membership keys (65,536 draws below
    # 2^20, de-duplicated) against as many random values as lineitem rows
    rng = np.random.default_rng(7)
    rvals = torch.from_numpy(rng.integers(0, 1 << 20, vals.numel(),
                                          dtype=np.int32)).cuda()
    keys = torch.from_numpy(np.unique(rng.integers(0, 1 << 20, 1 << 16,
                                                   dtype=np.int32))).cuda()
    got = launch_sorted(rvals, keys)
    want = membership_ref(rvals, keys)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K4 random values: kernel differs from its plain version")
    n, m = rvals.numel(), keys.numel()
    recs["membership"].append(case_record(
        f"K4 random values in {m} random keys, n={n}", got, want,
        time_ms(lambda: launch_sorted(rvals, keys)),
        time_ms(lambda: membership_ref(rvals, keys), inner=1),
        nbytes=4 * n + 4 * m + 4 * n, nops=n * (m.bit_length() + 1),
        ops_per_s=ALU_OPS_PER_S,
        library_ms=time_ms(lambda: torch.isin(rvals, keys), inner=1),
        set_keys=m, values="random"))
    del vals, rvals, got, want
    # K5: the kernel on the folded [BH, S, D] inputs; SDPA on [B, H, S, D]
    for (name, cfg, dt, s, h, d, window), (q, k, v) in zip(ATTN_CASES,
                                                            inp["attn"]):
        qf, kf, vf = fold(q), fold(k), fold(v)
        got = flash_attention(qf, kf, vf, window=window)
        want = attention_ref(qf, kf, vf, window=window)
        torch.cuda.synchronize()
        share, share_median = limit_share(got, want, qf, kf, vf, window,
                                          median=True)
        if share > 1:
            raise AssertionError(f"K5 {name} {dt}: kernel differs from its "
                                 f"plain version ({share:.3f} of the limit)")
        # the readings the limits are set from: the error against the size
        # of the outputs, its worst and median share of the per-element
        # limit, and RMS(err) / RMS(want); in bf16 the kernel is held to
        # BF16_RMS_LIMIT and a control that rounds the scores must fail it
        absw = want.float().abs()
        rms = rms_ratio(got, want)
        sizes = dict(out_abs_median=float(absw.median()),
                     out_abs_mean=float(absw.mean()),
                     out_abs_max=float(absw.max()), share_of_limit=share,
                     share_of_limit_median=share_median, rms_ratio=rms)
        del absw
        if dt == "bfloat16":
            control = rms_ratio(attention_bf16_scores(qf, kf, vf, window=window),
                                want)
            sizes.update(rms_limit=BF16_RMS_LIMIT, control_rms_ratio=control)
            if rms > BF16_RMS_LIMIT or control <= BF16_RMS_LIMIT:
                raise AssertionError(
                    f"K5 {name} {dt}: RMS ratio {rms:.3g} (limit "
                    f"{BF16_RMS_LIMIT}), control {control:.3g} must exceed it")
        q4, k4, v4 = (x.view(1, h, s, d) for x in (qf, kf, vf))

        def sdpa():
            return sdpa_call(q4, k4, v4, window)

        lib = sdpa().view(h, s, d)
        lib_err = float((lib.float() - want.float()).abs().max())
        lib_share = limit_share(lib, want, qf, kf, vf, window)
        lib_rms = rms_ratio(lib, want)
        del lib
        elem = qf.element_size()
        recs["flash_attention"].append(case_record(
            f"K5 mha_flash {name} {dt} S={s} H={h} D={d} window={window}",
            got, want,
            time_ms(lambda: flash_attention(qf, kf, vf, window=window),
                    reps=10, inner=2),
            time_ms(lambda: attention_ref(qf, kf, vf, window=window),
                    reps=5, inner=1),
            nbytes=4 * h * s * d * elem,
            # float32: three TF32 products a product, the CUDA cores' bound
            # beside it
            nops=(4 if dt == "bfloat16" else 12) * h * d * attention_pairs(s, window),
            ops_per_s=BF16_FLOPS_PER_S if dt == "bfloat16" else TF32_FLOPS_PER_S,
            bound_cuda_cores_ms=(None if dt == "bfloat16" else 4 * h * d * attention_pairs(
                s, window) / ALU_OPS_PER_S * 1e3),
            library_ms=time_ms(sdpa, reps=10, inner=2), config=cfg,
            library_max_abs_err=lib_err, library_share_of_limit=lib_share,
            library_rms_ratio=lib_rms,
            entry_s=secs[f"mha_flash {name} {dt}"], **sizes))
        del got, want
        torch.cuda.empty_cache()
        recs["flash_attention_backward"].append(k5_backward(
            f"mha_flash {name}", qf, kf, vf, window, smi,
            phase="entry_kernel_backward", config=cfg))
    return recs


# --------------------------------------------------------------------------- #
# phase 10: the LM serving path
# --------------------------------------------------------------------------- #
# the prefill shapes: B = 1, S = 4,096 (the repo's train_4k length); hymba's
# per-step mamba loop is also timed at S = 512
LM_PREFILL_S = 4096
HYMBA_TIMED_S = 512
DECODE_CHECK_S = 1024  # prompt of the prefill-against-decode check
# RMS(decode - prefill) / RMS(prefill) of the last logits: the relative
# tolerance of the reference's tests/test_models_smoke.py::
# test_decode_matches_prefill_logits
DECODE_RMS_LIMIT = 5e-2
LM_SERVE_ARGS = ["--arch", "llama3.2-3b", "--batch", "4", "--prompt-len",
                 "128", "--gen", "32"]
# head dim 96: phi-3-vision-4.2b at full width (32 layers, d 3,072, 32
# heads); head dim 32: every smoke configuration's, on the card at S = 4,096
PHI_ARCH = "phi-3-vision-4.2b"
SMOKE_ARCH = "llama3.2-3b"
SMOKE_TRAIN_B = 8


K5_FORWARDS = ("flash_attention", "flash_attention_fwd")


def wrap_k5_forwards(make) -> callable:
    """Wrap both of K5's forward wrappers as ``mha_flash`` calls them (the
    forward alone in prefill, the forward with its log-sum-exp under
    autograd): ``make(real, returns_lse)`` gives each wrapper.  Returns the
    undo."""
    from repro_torch.kernels.flash_attn import ops

    reals = {name: getattr(ops, name) for name in K5_FORWARDS}
    for name, real in reals.items():
        setattr(ops, name, make(real, name == "flash_attention_fwd"))
    return lambda: [setattr(ops, n, r) for n, r in reals.items()]


def keep_k5_calls(indices) -> tuple:
    """Wrap K5's forward wrappers as ``mha_flash`` calls them so the calls
    numbered ``indices`` (from 0, counted from now) keep their operands and
    output.  Returns (kept {index: (q, k, v, window, out)}, undo)."""
    kept, count = {}, [0]

    def make(real, returns_lse):
        def wrapper(q, k, v, window=None, **kw):
            res = real(q, k, v, window=window, **kw)
            # what the model sees: the node rounds the float32 o to q's dtype
            out = res[0].to(q.dtype) if returns_lse else res
            if count[0] in indices:  # a train step's operands carry autograd
                kept[count[0]] = (q.detach(), k.detach(), v.detach(), window,
                                  out.detach())
            count[0] += 1
            return res
        return wrapper

    return kept, wrap_k5_forwards(make)


def check_k5_calls(path: str, smi: str) -> tuple:
    """Wrap K5's forward wrappers as ``mha_flash`` calls them so that every
    call from now on is held against the plain version at once: within
    ``attention_limit`` per element and ``BF16_RMS_LIMIT`` over all
    elements (checks are not launches of the path).  Returns (done, undo):
    ``done()`` emits one line with the count and the worst shares, raises
    if a call failed, and unwraps."""
    from repro_torch.kernels.flash_attn import (BF16_RMS_LIMIT, attention_ref,
                                                rms_ratio)

    seen = {"checked": 0, "worst_share": 0.0, "worst_rms": 0.0}

    def make(real, returns_lse):
        def wrapper(q, k, v, window=None, **kw):
            res = real(q, k, v, window=window, **kw)
            out = res[0].to(q.dtype) if returns_lse else res
            with torch.no_grad():
                want = attention_ref(q, k, v, window=window)
                share = limit_share(out, want, q, k, v, window)
                rms = rms_ratio(out, want)
                del want
            seen["checked"] += 1
            seen["worst_share"] = max(seen["worst_share"], share)
            seen["worst_rms"] = max(seen["worst_rms"], rms)
            return res
        return wrapper

    undo = wrap_k5_forwards(make)

    def done() -> dict:
        undo()
        rec = {"phase": "mesh_k5_check", "path": path, **seen,
               "rms_limit": BF16_RMS_LIMIT, "nvidia_smi": smi}
        emit(rec)
        if seen["worst_share"] > 1 or seen["worst_rms"] > BF16_RMS_LIMIT:
            raise AssertionError(f"K5 on the {path}: {rec}")
        return rec

    return done


# the wgmma instances of K5's kernels: the bf16 forward (o in bf16 for
# prefill, in float32 with the log-sum-exp under autograd), the bf16
# backward and the float32 forward and backward, each with its
# shared-memory entry point's arguments (head dim, and the pass: 0 dK/dV,
# 1 dQ)
K5_WGMMA = {**{f"flash_attention_bf16<{d}, {o}>": ("flash_attention_bf16_smem", d, None)
               for o in ("__nv_bfloat16", "float") for d in (32, 64, 96, 128)},
            **{f"flash_bwd_{p}_{t}<{d}>": (f"flash_attention_bwd_{t}_smem", d, p == "dq")
               for t in ("bf16", "f32") for p in ("dkdv", "dq") for d in (32, 64, 96, 128)},
            **{f"flash_attention_f32<{d}>": ("flash_attention_f32_smem", d, None)
               for d in (32, 64, 96, 128)}}


def phase_k5_bwd_build(lib, smi: str) -> None:
    """Resources and SASS of K5's wgmma kernels (the bf16 forward and
    backward, the float32 forward and backward): registers, stack and spill
    bytes from ``ptxas -v`` (kept beside the library), their dynamic shared
    memory from the library; the count of ``HGMMA`` (wgmma), ``UTMALDG``
    (TMA loads) and ``HMMA`` (mma.sync) in each.  Each must hold wgmma and
    TMA loads and no mma.sync, where the toolkit has ``cuobjdump``."""
    import ctypes

    from repro_torch.kernels import _build

    def smem(entry, d, dq):
        if dq is None:
            return _build.launcher(entry, ctypes.c_int)(d)
        return _build.launcher(entry, ctypes.c_int, ctypes.c_int)(d, int(dq))

    res = _build.resources((lib.parent / _build.PTXAS_LOG).read_text())
    missing = [k for k in K5_WGMMA if k not in res]
    rec = {k: {**res.get(k, {}), "dynamic_smem": smem(*args)}
           for k, args in K5_WGMMA.items()}
    emit({"phase": "k5_bwd_resources", "kernels": rec, "nvidia_smi": smi})
    text = _build.sass(lib)
    counts = None if text is None else _build.sass_counts(
        text, ("HGMMA", "UTMALDG", "HMMA"))
    emit({"phase": "k5_bwd_sass", "nvidia_smi": smi,
          "kernels": None if counts is None else {k: counts.get(k) for k in K5_WGMMA},
          "note": "no cuobjdump in the toolkit" if counts is None else None})
    if missing:
        raise AssertionError(f"ptxas -v printed nothing for {missing}")
    if counts is not None:
        wrong = {k: counts.get(k) for k in K5_WGMMA
                 if not counts.get(k) or not counts[k]["HGMMA"]
                 or not counts[k]["UTMALDG"] or counts[k]["HMMA"]}
        if wrong:
            raise AssertionError(f"K5 kernels not on wgmma and TMA alone: {wrong}")


def k5_launches() -> int:
    from repro_torch.kernels.flash_attn import LAUNCHES

    return LAUNCHES["flash_attention"]


def k5_bwd_launches() -> int:
    from repro_torch.kernels.flash_attn import LAUNCHES

    return LAUNCHES["flash_attention_backward"]


PLAIN_ATTENTION = ("attention_ref", "attention_lse_ref", "attention_bwd_ref")


class plain_off_card:
    """While open, a call of K5's plain versions (the forward, its
    log-sum-exp, the backward) on a CUDA tensor raises, wherever the port
    binds them: the timed steps must run the kernels.  Entering checks that
    the guard fires."""

    def __enter__(self):
        from repro_torch.kernels import flash_attn as pkg
        from repro_torch.kernels.flash_attn import flash_attn, ops, ref

        def guard(name, fn):
            def call(*args, **kw):
                if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                    raise AssertionError(f"{name} ran on the card in a timed step")
                return fn(*args, **kw)
            return call

        self.saved = [(m, n, getattr(m, n)) for m in (pkg, flash_attn, ops, ref)
                      for n in PLAIN_ATTENTION if hasattr(m, n)]
        for m, n, fn in self.saved:
            setattr(m, n, guard(n, fn))
        x = torch.zeros((1, 8, 32), device="cuda")
        try:
            ops.mha_ref(x[..., None, :], x[..., None, :], x[..., None, :])
        except AssertionError:
            return self
        self.__exit__()
        raise AssertionError("the plain attention's guard did not fire")

    def __exit__(self, *exc):
        for m, n, fn in reversed(self.saved):
            setattr(m, n, fn)
        return False


def timed_prefill(step, model, batch) -> tuple:
    """One prefill call: (logits, host seconds to the synchronise, K5
    launches)."""
    torch.cuda.synchronize()
    before = k5_launches()
    t0 = time.perf_counter()
    logits = step(model, batch)
    torch.cuda.synchronize()
    return logits, time.perf_counter() - t0, k5_launches() - before


def sdpa_call(q4, k4, v4, window):
    """``scaled_dot_product_attention`` of ``[B, H, S, D]`` tensors, causal,
    the window as a boolean mask: the library's yardstick."""
    import torch.nn.functional as F

    if window is None:
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    s = q4.shape[2]
    pos = torch.arange(s, device=q4.device)
    keep = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=keep)


def k5_backward(label: str, q, k, v, window, smi: str,
                phase: str = "k5_backward", **extra) -> dict:
    """The backward kernel on one K5 case's ``[BH, S, D]`` operands: o and
    lse from the forward kernel, dO a seeded normal draw.  The backward
    reference reads that o and lse, so each is first held to its own plain
    version: lse within 2e-5 (1 + |lse|) of ``attention_lse_ref``, the
    float32 o, unrounded, within ``attention_limit`` of ``attention_ref``
    of the float32 inputs (and, in bf16, within ``BF16_RMS_LIMIT``).  Then
    dq, dk and dv against ``attention_bwd_ref`` on the same inputs
    (float32: within ``attention_bwd_limit`` per element; bf16: each within
    ``BWD_BF16_RMS_LIMIT``, which the control that rounds the scores must
    exceed), bit-equal over two runs; kernel, plain and SDPA-backward times
    beside the bound, 10 D flops per unmasked pair and head.  These
    launches are checks, not the path's."""
    from repro_torch.kernels.flash_attn import (BF16_RMS_LIMIT,
                                                BWD_BF16_RMS_LIMIT,
                                                attention_bwd_bf16_scores,
                                                attention_bwd_limit,
                                                attention_bwd_ref,
                                                attention_lse_ref,
                                                attention_pairs, attention_ref,
                                                flash_attention_backward,
                                                flash_attention_fwd, rms_ratio)

    bh, s, d = q.shape
    bf16 = q.dtype == torch.bfloat16
    o, lse = flash_attention_fwd(q, k, v, window=window)
    want_lse = attention_lse_ref(q, k, v, window=window)
    lse_share = float(((lse - want_lse).abs() / (2e-5 * (1 + want_lse.abs()))).max())
    del want_lse
    want_o = attention_ref(q.float(), k.float(), v.float(), window=window)
    o_share = limit_share(o, want_o, q, k, v, window)
    o_rms = rms_ratio(o, want_o)
    del want_o
    torch.cuda.empty_cache()
    fwd_ok = lse_share <= 1 and o_share <= 1 and (not bf16 or o_rms <= BF16_RMS_LIMIT)
    gen = torch.Generator(device="cuda").manual_seed(14)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    args = (q, k, v, o, lse, do)
    got = flash_attention_backward(*args, window=window)
    again = flash_attention_backward(*args, window=window)
    want = attention_bwd_ref(*args, window=window)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    rec = {"case": f"K5 backward {label}: BH={bh} S={s} D={d} window={window} "
                   f"{str(q.dtype).split('.')[-1]}",
           "max_abs_err": max(float((a.float() - b.float()).abs().max())
                              for a, b in zip(got, want)),
           "rms_ratio": [rms_ratio(a, b) for a, b in zip(got, want)],
           "bit_equal_rerun": same, "lse_share_of_limit": lse_share,
           "o_f32_share_of_limit": o_share, "o_f32_rms_ratio": o_rms}
    if bf16:
        control = attention_bwd_bf16_scores(*args, window=window)
        rec.update(rms_limit=BWD_BF16_RMS_LIMIT, control_rms_ratio=[
            rms_ratio(a, b) for a, b in zip(control, want)])
        del control
        ok = (max(rec["rms_ratio"]) <= BWD_BF16_RMS_LIMIT
              and min(rec["control_rms_ratio"]) > BWD_BF16_RMS_LIMIT)
    else:
        lims = attention_bwd_limit(*args, window=window)
        rec["share_of_limit"] = max(float(((a - b).abs() / lim).max())
                                    for a, b, lim in zip(got, want, lims))
        del lims
        ok = rec["share_of_limit"] <= 1
    del got, want
    torch.cuda.empty_cache()
    q4, k4, v4 = (t.detach().view(1, bh, s, d).requires_grad_() for t in (q, k, v))
    lib = sdpa_call(q4, k4, v4, window)
    do4 = do.view(1, bh, s, d)
    # q, k, v, dO, dq, dk, dv in q's type; o and lse in float32
    nbytes = (7 * q.element_size() + 4) * bh * s * d + 4 * bh * s
    # float32: three TF32 products a product (the CUDA cores' bound beside)
    nops = (10 if bf16 else 30) * d * bh * attention_pairs(s, window)
    peak = BF16_FLOPS_PER_S if bf16 else TF32_FLOPS_PER_S
    if not bf16:
        rec["bound_cuda_cores_ms"] = 10 * d * bh * attention_pairs(s, window) / ALU_OPS_PER_S * 1e3
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": nops / peak * 1e3}
    rec.update(
        backward_kernel_ms=time_ms(lambda: flash_attention_backward(*args, window=window),
                                   reps=10, inner=2),
        backward_plain_ms=time_ms(lambda: attention_bwd_ref(*args, window=window),
                                  reps=3, inner=1),
        backward_library_ms=time_ms(
            lambda: torch.autograd.grad(lib, (q4, k4, v4), do4, retain_graph=True),
            reps=10, inner=2),
        bound_ms=max(bound.values()), bound_by=max(bound, key=bound.get),
        bound_bytes=nbytes, bound_ops=nops, nvidia_smi=smi, **extra)
    emit({"phase": phase, **rec})
    del lib, q4, k4, v4
    torch.cuda.empty_cache()
    if not fwd_ok:
        raise AssertionError(f"K5 forward's o or lse, which the backward "
                             f"reads, differs from its plain version: {rec}")
    if not ok or not same:
        raise AssertionError(f"K5 backward kernel differs from its plain "
                             f"version: {rec}")
    return rec


def replay_k5(name, layer, kept, smi, path: str = "prefill",
              phase: str = "lm_kernel", backward: bool = False,
              **extra) -> dict:
    """One kept K5 launch of the model path against its plain version:
    within ``attention_limit`` per element and ``BF16_RMS_LIMIT`` over all
    elements; kernel, plain and SDPA times on the same operands.  With
    ``backward``, the backward kernel on the same operands
    (:func:`k5_backward`), its record under ``"backward"``."""
    from repro_torch.kernels.flash_attn import (BF16_RMS_LIMIT, attention_pairs,
                                                attention_ref, flash_attention,
                                                rms_ratio)

    q, k, v, window, got = kept
    want = attention_ref(q, k, v, window=window)
    share, share_median = limit_share(got, want, q, k, v, window, median=True)
    rms = rms_ratio(got, want)
    if share > 1 or rms > BF16_RMS_LIMIT:
        raise AssertionError(f"K5 {name} layer {layer}: {share:.3f} of the "
                             f"limit, RMS ratio {rms:.3g}")
    bh, s, d = q.shape
    q4, k4, v4 = (x.view(1, bh, s, d) for x in (q, k, v))

    def sdpa():
        return sdpa_call(q4, k4, v4, window)

    rec = case_record(
        f"K5 {name} {path} layer {layer}: BH={bh} S={s} D={d} window={window}",
        got, want,
        time_ms(lambda: flash_attention(q, k, v, window=window), reps=10,
                inner=2),
        time_ms(lambda: attention_ref(q, k, v, window=window), reps=5, inner=1),
        nbytes=4 * bh * s * d * q.element_size(),
        nops=4 * bh * d * attention_pairs(s, window),
        ops_per_s=BF16_FLOPS_PER_S,
        library_ms=time_ms(sdpa, reps=10, inner=2), phase=phase,
        model=name, layer=layer, share_of_limit=share,
        share_of_limit_median=share_median, rms_ratio=rms,
        rms_limit=BF16_RMS_LIMIT, nvidia_smi=smi, **extra)
    del want
    torch.cuda.empty_cache()
    if backward:
        rec["backward"] = k5_backward(f"{name} {path} layer {layer}", q, k, v,
                                      window, smi, phase=f"{phase}_backward")
    return rec


def prefill_flops(model, s: int) -> int:
    """2 x non-embedding parameters x tokens + 2 x the causal attention
    products (QK^T and PV, 2 H D multiply-adds per unmasked pair) of every
    layer."""
    from repro_torch.kernels.flash_attn import attention_pairs

    cfg = model.cfg
    n = sum(p.numel() for name, p in model.named_parameters()
            if name not in ("embed", "lm_head"))
    pairs = attention_pairs(s, cfg.sliding_window)
    return 2 * n * s + 2 * cfg.n_layers * 2 * cfg.n_heads * cfg.hd * pairs


def prompt_batch(cfg, s: int, gen) -> dict:
    """One prompt of ``s`` positions on the card: random tokens and, for a
    vision configuration, its ``n_patches`` patch embeddings first (the
    stub frontend's input), so the sequence is ``s`` long either way."""
    vision = cfg.frontend == "vision"
    text = s - cfg.n_patches if vision else s
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, text), generator=gen,
                                     device="cuda")}
    if vision:
        batch["patches"] = torch.randn((1, cfg.n_patches, cfg.d_model),
                                       generator=gen, device="cuda").to(
                                           torch.bfloat16)
    return batch


def lm_model(name: str, smi: str):
    """``Model.init`` of the full configuration in bf16 on the card, seed 0."""
    from repro_torch.configs import get
    from repro_torch.models.model import Model

    cfg = get(name)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = Model.init(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    params = sum(p.numel() for p in model.parameters())
    emit({"phase": "lm_init", "model": name, "seconds": time.perf_counter() - t0,
          "params": params, "param_bytes": 2 * params, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "heads": cfg.n_heads,
          "kv_heads": cfg.n_kv_heads, "head_dim": cfg.hd,
          "window": cfg.sliding_window, "padded_vocab": cfg.padded_vocab,
          "nvidia_smi": smi})
    return model


def lm_prefill(model, s: int, smi: str, reps: int, k5_ms=None) -> tuple:
    """Prefill B = 1 at ``s`` tokens: one warm-up call whose first and last
    layer's K5 launches are kept for the replay, then ``reps`` timed calls,
    each launching K5 once a layer.  Returns (record, {layer: kept
    launch})."""
    from repro_torch.launch.steps import make_prefill_step

    cfg = model.cfg
    L = cfg.n_layers
    step = make_prefill_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(10)
    batch = prompt_batch(cfg, s, gen)
    torch.cuda.reset_peak_memory_stats()
    kept, undo = keep_k5_calls({0, L - 1})
    try:
        logits, warm_s, warm_launches = timed_prefill(step, model, batch)
    finally:
        undo()
    runs = [timed_prefill(step, model, batch) for _ in range(reps)]
    launches = [warm_launches] + [n for _, _, n in runs]
    for out in [logits] + [lg for lg, _, _ in runs]:
        if out.shape != (1, 1, cfg.padded_vocab) or not torch.isfinite(
                out[..., :cfg.vocab].float()).all():
            raise AssertionError(f"{cfg.name} prefill: bad logits")
    secs = [t for _, t, _ in runs]
    med = statistics.median(secs)
    flops = prefill_flops(model, s)
    rec = {"phase": "lm_prefill", "model": cfg.name, "B": 1, "S": s,
           "warmup_s": warm_s, "seconds": secs, "seconds_median": med,
           "tokens_per_s": s / med,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "model_flops": flops,
           "flops_formula": "2 x non-embedding params x tokens + 2 x 2 H D "
                            "x unmasked (query, key) pairs x layers",
           "flop_rate": flops / med, "share_of_bf16_peak":
           flops / med / BF16_FLOPS_PER_S, "nvidia_smi": smi}
    if k5_ms is not None:
        rec.update(k5_ms_phase6=k5_ms, k5_share_of_prefill=L * k5_ms * 1e-3 / med,
                   k5_share_formula="layers x phase 6's K5 ms at this shape "
                                    "/ prefill median")
    rec["k5_launches_per_call"] = launches
    emit(rec)
    if any(n != L for n in launches):
        raise AssertionError(f"{cfg.name} prefill: K5 launches {launches}, "
                             f"want {L} a call")
    return rec, kept


def lm_decode_vs_prefill(model, smi: str) -> dict:
    """One prompt through ``prefill`` (K5) and token by token through
    ``decode_step`` (plain attention over the cache): the last position's
    logits must give the same top-1 token, RMS ratio within
    ``DECODE_RMS_LIMIT``."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    cfg, s = model.cfg, DECODE_CHECK_S
    gen = torch.Generator(device="cuda").manual_seed(11)
    prompt = torch.randint(0, cfg.vocab, (1, s), generator=gen, device="cuda")
    before = k5_launches()
    full = make_prefill_step(cfg)(model, {"tokens": prompt})
    prefill_launches = k5_launches() - before
    step = make_decode_step(cfg)
    state = model.init_decode_state(1, s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(s):
        logits, state = step(model, state, prompt[:, i:i + 1])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    a = full[0, -1, :cfg.vocab].float()
    b = logits[0, -1, :cfg.vocab].float()
    ratio = float((b - a).square().mean().sqrt() / a.square().mean().sqrt())
    rec = {"phase": "lm_decode_vs_prefill", "model": cfg.name, "prompt": s,
           "top1_prefill": int(a.argmax()), "top1_decode": int(b.argmax()),
           "rms_ratio": ratio, "rms_limit": DECODE_RMS_LIMIT,
           "decode_seconds": secs, "decode_tokens_per_s": s / secs,
           "k5_launches_prefill": prefill_launches, "nvidia_smi": smi}
    emit(rec)
    if prefill_launches != cfg.n_layers:
        raise AssertionError(f"{cfg.name}: {prefill_launches} K5 launches")
    if rec["top1_prefill"] != rec["top1_decode"] or ratio > DECODE_RMS_LIMIT:
        raise AssertionError(f"{cfg.name}: decode and prefill disagree: {rec}")
    del state
    return rec


def lm_serve(smi: str) -> dict:
    """``launch/serve.py``'s main on the card: llama3.2-3b, 4 prompts of
    128 tokens through decode steps, then 32 greedy tokens each."""
    import contextlib
    import io
    import re

    from repro_torch.configs import get
    from repro_torch.launch import serve

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        gen = serve.main(LM_SERVE_ARGS)
    secs = time.perf_counter() - t0
    printed = buf.getvalue().splitlines()
    for line in printed:
        print(line, flush=True)
    if gen.shape != (4, 32) or not ((gen >= 0) & (gen < get("llama3.2-3b").vocab)).all():
        raise AssertionError(f"serve returned {gen.shape} tokens")
    m = re.search(r"prefill (\d+) toks in ([\d.]+)s, decode (\d+) toks in "
                  r"([\d.]+)s \(([\d.]+) tok/s", printed[0])
    rec = {"phase": "lm_serve", "args": LM_SERVE_ARGS, "tokens_shape":
           list(gen.shape), "prefill_s": float(m[2]), "decode_s": float(m[4]),
           "decode_tokens_per_s": float(m[5]), "seconds": secs,
           "printed": printed, "nvidia_smi": smi}
    emit(rec)
    return rec


def lm_smoke(smi: str) -> dict:
    """``smoke_config(SMOKE_ARCH)`` (head dim 32) in bf16 on the card: a
    prefill at B = 1, S = 4,096 (K5 once a layer) and one train step at
    B = ``SMOKE_TRAIN_B``, S = 4,096, remat on, one microbatch (K5 twice a
    layer: the forward and remat's recompute), the step's first launch
    kept for the replay.  Returns the launches, the kept launch and the
    record."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.steps import make_prefill_step, make_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw

    cfg = smoke_config(SMOKE_ARCH)
    L = cfg.n_layers
    model = Model.init(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(13)
    logits, pre_s, pre_n = timed_prefill(make_prefill_step(cfg), model,
                                         prompt_batch(cfg, LM_PREFILL_S, gen))
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=0)
    opt = adamw.init(dict(model.named_parameters()), opt_cfg)
    toks = torch.randint(0, cfg.vocab, (SMOKE_TRAIN_B, LM_PREFILL_S),
                         generator=gen, device="cuda")
    kept, undo = keep_k5_calls({0})
    try:
        opt, m, step_s, step_n, step_bwd = timed_train_step(
            make_train_step(cfg, opt_cfg), model, opt,
            {"tokens": toks, "labels": toks})
    finally:
        undo()
    rec = {"phase": "lm_smoke", "model": cfg.name, "head_dim": cfg.hd,
           "layers": L, "S": LM_PREFILL_S, "prefill_s": pre_s,
           "prefill_k5_launches": pre_n, "train_B": SMOKE_TRAIN_B,
           "train_step_s": step_s, "train_k5_launches": step_n,
           "train_k5_backward_launches": step_bwd,
           "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "nvidia_smi": smi}
    emit(rec)
    if logits.shape != (1, 1, cfg.padded_vocab) or not torch.isfinite(
            logits[..., :cfg.vocab].float()).all():
        raise AssertionError(f"{cfg.name} prefill: bad logits")
    if pre_n != L or step_n != 2 * L or step_bwd != L or not np.isfinite(
            rec["loss"]):
        raise AssertionError(f"{cfg.name} on the card: {rec}")
    del model, opt, logits
    return {"launches": pre_n + step_n, "bwd_launches": step_bwd, "kept": kept,
            "record": rec}


def free_card() -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def phase_lm(smi: str, k5_entry_recs) -> dict:
    """Phase 10: llama3.2-3b, hymba-1.5b and phi-3-vision-4.2b (head dim
    96) at full width and depth in bf16 through the port's serving entry
    points, and a smoke configuration (head dim 32) prefilled and trained
    one step, K5's launch count at 0 just before and read just after; then
    the kept launches against the plain version (not counted).  Returns
    the launches and replay records (``k5_entry_recs``, phase 6's K5
    records, give llama's K5 share of prefill when there are any)."""
    from repro_torch.kernels import flash_attn

    t_phase = time.perf_counter()
    llama_ms = next((r["ms"] for r in k5_entry_recs or ()
                     if "llama3.2-3b bfloat16" in r["case"]), None)
    flash_attn.reset_launches()  # both K5 kernels' counts
    model = lm_model("llama3.2-3b", smi)
    llama, kept_llama = lm_prefill(model, LM_PREFILL_S, smi, reps=3,
                                   k5_ms=llama_ms)
    check = lm_decode_vs_prefill(model, smi)
    del model
    free_card()
    lm_serve(smi)
    free_card()
    t0 = time.perf_counter()
    model = lm_model("hymba-1.5b", smi)
    hymba, kept_hymba = lm_prefill(model, LM_PREFILL_S, smi, reps=1)
    short, _ = lm_prefill(model, HYMBA_TIMED_S, smi, reps=1)
    emit({"phase": "lm_hymba_total", "seconds": time.perf_counter() - t0})
    del model
    free_card()
    t0 = time.perf_counter()
    model = lm_model(PHI_ARCH, smi)
    phi, kept_phi = lm_prefill(model, LM_PREFILL_S, smi, reps=1)
    del model
    free_card()
    smoke = lm_smoke(smi)
    free_card()
    emit({"phase": "lm_head_dims_total", "seconds": time.perf_counter() - t0})
    launches, bwd_launches = k5_launches(), k5_bwd_launches()
    prefills = [llama, hymba, short, phi]
    counted = (sum(sum(r["k5_launches_per_call"]) for r in prefills)
               + check["k5_launches_prefill"] + smoke["launches"])
    emit({"phase": "lm_launches", "k5_launches": launches,
          "k5_launches_of_prefill_calls": counted,
          "k5_backward_launches": bwd_launches,
          "k5_backward_launches_of_train_step": smoke["bwd_launches"]})
    if launches != counted or bwd_launches != smoke["bwd_launches"]:
        raise AssertionError(f"K5 launched {launches} / {bwd_launches} times "
                             f"in phase 10, its calls account for {counted} / "
                             f"{smoke['bwd_launches']}")
    replays = []
    for rec, kept in ((llama, kept_llama), (hymba, kept_hymba), (phi, kept_phi)):
        # the backward kernel at each head dim on layer 0's operands
        mine = [replay_k5(rec["model"], i, kept[i], smi, backward=i == 0)
                for i in sorted(kept)]
        emit({"phase": "lm_k5_share", "model": rec["model"], "S": rec["S"],
              "k5_share_of_prefill_replayed":
              rec["k5_launches_per_call"][0] * statistics.mean(
                  r["ms"] for r in mine) * 1e-3 / rec["seconds_median"]})
        replays += mine
        kept.clear()
    d32 = replay_k5(smoke["record"]["model"], 0, smoke["kept"][0], smi,
                    path="smoke train step", backward=True)
    smoke["kept"].clear()
    free_card()
    emit({"phase": "lm_total", "seconds": time.perf_counter() - t_phase,
          "k5_launches": launches})
    return {"launches": launches, "bwd_launches": bwd_launches,
            "replays": replays + [d32],
            "per_prefill": {r["model"]: r["k5_launches_per_call"][0]
                            for r in (llama, hymba, phi)},
            "head_dims": {"d96": next(r for r in replays if r["model"] == PHI_ARCH),
                          "d32": d32}}


# --------------------------------------------------------------------------- #
# phase 11: the training path
# --------------------------------------------------------------------------- #
# qwen2-0.5b at full width and depth (launch/train's default arch), the
# train_4k sequence length, B = 8 in 4 microbatches of 2, remat on
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_B, TRAIN_S, TRAIN_ACCUM = 8, 4096, 4
TRAIN_TIMED = 5  # after one warm-up step
TRAIN_DOCS = 2000
TRAIN_CKPT_AFTER = 3  # saved after this step, restored, the next step replayed
TRAIN_CKPT_DIR = os.path.join(ROOT, "build", "chip_smoke_ckpt")
TRAIN_F32_B = 2  # the float32 step: one microbatch of phase 11's
# RMS(K5 route - plain route) / RMS(plain route) of every parameter's
# gradient: the reference's bf16 tolerance, as in phase 10
GRAD_RMS_LIMIT = 5e-2
# the float32 step's: K5's float32 kernels are held per element to 2e-5 of
# a spread (``attention_bwd_limit``); the float32 routes differ only in
# the order and splitting of their float32 sums
GRAD_RMS_LIMIT_F32 = 2e-5
CKPT_LOSS_RTOL = 1e-3
# 6 steps, one checkpoint: 12 steps took phase 11 past 100 s
TRAIN_MAIN_ARGS = ["--arch", TRAIN_ARCH, "--steps", "6", "--batch", "4",
                   "--seq", "512", "--ckpt-every", "6", "--ckpt-dir",
                   os.path.join(ROOT, "build", "chip_smoke_train_main")]


def train_pipeline(vocab: int, smi: str) -> tuple:
    """``LineageDataPipeline`` over ``TRAIN_DOCS`` synthetic documents at
    the model's vocabulary on the card, built and queried with the scan
    cutovers forced to 0: its K1/K2 launches are kept.  ``lineage_of`` the
    first document of step 0 must equal a numpy-backend PredTrace's answer
    on the same plan.  Returns (pipeline, kept launches, launches by
    variant)."""
    from repro_torch.core import PredTrace, ScanEngine
    from repro_torch.data.pipeline import LineageDataPipeline, synth_corpus
    from repro_torch.kernels.pred_filter import LAUNCHES, reset_launches

    catalog, tokens = synth_corpus(n_docs=TRAIN_DOCS, vocab=vocab, seed=0)
    calls, stage = [], {"query": "train pipeline", "name": "build"}
    for k in CUTOVER_ENV:
        os.environ[k] = "0"
    unwrap = capture_batch_launches(calls, stage)
    reset_launches()
    try:
        t0 = time.perf_counter()
        pipe = LineageDataPipeline(catalog, tokens, seq_len=TRAIN_S,
                                   batch=TRAIN_B, seed=0, device="cuda")
        build_s = time.perf_counter() - t0
        built = dict(LAUNCHES)
        did = int(pipe.batch_at(0)["doc_ids"][0, 0])
        stage["name"] = "lineage_of"
        t0 = time.perf_counter()
        got = pipe.lineage_of(did)
        lineage_s = time.perf_counter() - t0
    finally:
        unwrap()
        for k in CUTOVER_ENV:
            os.environ.pop(k, None)
    launches = dict(LAUNCHES)
    oracle = PredTrace(catalog, pipe.plan, scan_engine=ScanEngine("numpy"))
    oracle.infer()
    out = oracle.run().output
    for c in out.columns:
        if not np.array_equal(out[c], pipe.selected[c]):
            raise AssertionError(f"train pipeline: selected column {c} differs")
    want = oracle.query(int(np.nonzero(out["doc_id"] == did)[0][0]))
    if not _answers_equal(got, want):
        raise AssertionError(f"train pipeline: lineage_of({did}) differs from "
                             f"numpy")
    emit({"phase": "train_pipeline", "docs": TRAIN_DOCS,
          "selected": int(pipe.selected.nrows), "build_s": build_s,
          "lineage_of_doc": did, "lineage_of_s": lineage_s,
          "lineage_rows": {k: len(v) for k, v in got.lineage.items()},
          "precise": got.precise, "identical_to_numpy": True,
          "launches_build": built, "launches_total": launches,
          "nvidia_smi": smi})
    if len(calls) != launches["cmp"] + launches["sets"] or not calls:
        raise AssertionError(f"train pipeline: {len(calls)} kept calls, "
                             f"launches {launches}")
    return pipe, calls, launches


def train_batch(pipe, step: int) -> dict:
    raw = pipe.batch_at(step)
    return {k: torch.from_numpy(raw[k]).cuda() for k in ("tokens", "labels")}


def train_flops(model, tokens: int, sequences: int) -> int:
    """6 x N x tokens (N: every parameter but the embedding table) plus 3 x
    the causal attention products (forward and backward), plus remat's
    extra forward: 2 x the blocks' parameters x tokens and 1 x the
    attention products; the attention products are 2 x 2 H D per unmasked
    (query, key) pair (QK^T, PV), every layer and sequence."""
    from repro_torch.kernels.flash_attn import attention_pairs

    cfg = model.cfg
    named = dict(model.named_parameters())
    n = sum(p.numel() for k, p in named.items() if k != "embed")
    n_blocks = sum(p.numel() for k, p in named.items() if k.startswith("layers."))
    attn = (4 * cfg.n_heads * cfg.hd * attention_pairs(TRAIN_S, cfg.sliding_window)
            * cfg.n_layers * sequences)
    return 6 * n * tokens + 3 * attn + 2 * n_blocks * tokens + attn


def timed_train_step(step, model, opt, batch) -> tuple:
    """One train step: (opt, metrics, host seconds to a synchronise, K5
    forward launches, K5 backward launches)."""
    torch.cuda.synchronize()
    before, before_bwd = k5_launches(), k5_bwd_launches()
    t0 = time.perf_counter()
    model, opt, metrics = step(model, opt, batch)
    torch.cuda.synchronize()
    return (opt, metrics, time.perf_counter() - t0, k5_launches() - before,
            k5_bwd_launches() - before_bwd)


def train_grad_check(model, batch, smi: str, phase: str = "train_grad_check",
                     limit: float = GRAD_RMS_LIMIT) -> dict:
    """One microbatch through ``loss_fn`` under autograd twice, the same
    weights and batch: the K5 route (``mha_flash``, the FlashAttention
    node: the forward and backward kernels) and the plain route
    (``mha_ref`` under autograd).  Every
    parameter's gradient within ``limit`` (RMS ratio); the attention weights
    and biases must have non-zero gradients on the K5 route."""
    from repro_torch.kernels.flash_attn import ops, rms_ratio
    from repro_torch.models import layers

    mb = {k: v[:TRAIN_B // TRAIN_ACCUM] for k, v in batch.items()}
    params = dict(model.named_parameters())

    def grads():
        loss = model.loss_fn(mb)
        return float(loss.detach()), torch.autograd.grad(loss, list(params.values()))

    before, before_bwd = k5_launches(), k5_bwd_launches()
    t0 = time.perf_counter()
    loss_k5, g_k5 = grads()
    torch.cuda.synchronize()
    k5_s = time.perf_counter() - t0
    launches, bwd_launches = k5_launches() - before, k5_bwd_launches() - before_bwd
    layers.mha_flash = ops.mha_ref
    t0 = time.perf_counter()
    try:
        loss_plain, g_plain = grads()
        torch.cuda.synchronize()
    finally:
        layers.mha_flash = ops.mha_flash
    plain_s = time.perf_counter() - t0
    worst, zero = {}, []
    for name, a, b in zip(params, g_k5, g_plain):
        kind = name.split(".")[-1]
        r = rms_ratio(a, b)
        if r > worst.get(kind, (-1.0,))[0]:
            worst[kind] = (r, name)
        if kind in ("wq", "wk", "wv", "bq", "bk", "bv") and not bool(a.abs().max() > 0):
            zero.append(name)
    rec = {"phase": phase, "model": TRAIN_ARCH,
           "dtype": str(model.embed.dtype).split(".")[-1],
           "microbatch": TRAIN_B // TRAIN_ACCUM, "S": TRAIN_S, "remat": True,
           "loss_k5": loss_k5, "loss_plain": loss_plain,
           "k5_launches": launches, "k5_backward_launches": bwd_launches,
           "k5_route_s": k5_s,
           "plain_route_s": plain_s,
           "worst_rms_ratio_by_kind": {k: v[0] for k, v in sorted(worst.items())},
           "worst_leaf_by_kind": {k: v[1] for k, v in sorted(worst.items())},
           "rms_limit": limit, "zero_attention_grads": zero,
           "nvidia_smi": smi}
    emit(rec)
    del g_k5, g_plain
    if zero or max(v[0] for v in worst.values()) > limit:
        raise AssertionError(f"K5-route gradients: {rec}")
    if launches != 2 * model.cfg.n_layers or bwd_launches != model.cfg.n_layers:
        raise AssertionError(f"gradient check launched K5 {launches} times, "
                             f"its backward {bwd_launches}")
    return rec


def train_checkpoint_save(model, opt, n: int) -> tuple:
    """Save ``train_state(model, opt)`` after step ``n`` under build/, then
    restore it on the card into a fresh model and AdamW state: every leaf
    bit-identical.  Returns (fresh model, restored state, record)."""
    import shutil

    from repro_torch.checkpoint.manager import CheckpointManager, flatten, train_state
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw

    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    ckpt = CheckpointManager(TRAIN_CKPT_DIR, keep=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = ckpt.save(n, train_state(model, opt))
    save_s = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in path.iterdir())
    fresh = Model(model.cfg, "cuda", torch.bfloat16)
    like = train_state(fresh, adamw.init(dict(fresh.named_parameters()),
                                         adamw.AdamWConfig()))
    t0 = time.perf_counter()
    got_step, tree = ckpt.restore(like, device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del like
    fresh.load_state_dict(tree["params"])
    opt2 = tree["opt"]
    del tree
    mine, theirs = flatten(train_state(fresh, opt2)), flatten(train_state(model, opt))
    same = [a == b and x.dtype == y.dtype and torch.equal(x, y)
            for (a, x), (b, y) in zip(mine, theirs)]
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    rec = {"step": n, "save_s": save_s, "restore_s": restore_s,
           "bytes": nbytes, "leaves": len(theirs),
           "bit_identical": len(mine) == len(theirs) and all(same)}
    if got_step != n or not rec["bit_identical"]:
        raise AssertionError(f"checkpoint: step {got_step} of {n}, "
                             f"{sum(same)} of {len(theirs)} leaves identical")
    return fresh, opt2, rec


def train_main(smi: str) -> dict:
    """``launch/train.py``'s main on the card at full width: qwen2-0.5b, 6
    steps of batch 4 at S = 512, a checkpoint after step 6, its own
    512-document pipeline and lineage query."""
    import contextlib
    import io
    import shutil

    from repro_torch.launch import train

    ckpt_dir = TRAIN_MAIN_ARGS[-1]
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    buf = io.StringIO()
    before, before_bwd = k5_launches(), k5_bwd_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        losses = train.main(TRAIN_MAIN_ARGS)
    secs = time.perf_counter() - t0
    launches, bwd_launches = k5_launches() - before, k5_bwd_launches() - before_bwd
    printed = buf.getvalue().splitlines()
    for line in printed:
        print(line, flush=True)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    rec = {"phase": "train_main", "args": TRAIN_MAIN_ARGS[:-2],
           "losses": losses, "seconds": secs, "k5_launches": launches,
           "k5_backward_launches": bwd_launches, "printed": printed,
           "nvidia_smi": smi}
    emit(rec)
    if (len(losses) != 6 or not np.isfinite(losses).all()
            or not any(line.startswith("[lineage] doc") for line in printed)):
        raise AssertionError("launch/train: bad losses or no [lineage] line")
    return rec


def capture_attention(calls: list):
    """While on, every ``mha_flash`` call of the model appends its
    ``[B, S, H, D]`` q, k, v (detached) to ``calls``; returns the function
    that turns it off."""
    from repro_torch.kernels.flash_attn import ops
    from repro_torch.models import layers

    def recording(q, k, v, window=None):
        calls.append((q.detach(), k.detach(), v.detach(), window))
        return ops.mha_flash(q, k, v, window=window)

    layers.mha_flash = recording

    def off():
        layers.mha_flash = ops.mha_flash
    return off


def largest_scale(calls: list) -> dict:
    """Of the ``capture_attention`` calls of one forward (a call a layer),
    the layer of the largest std(q) std(k): its index, every layer's
    product, and its q, k, v folded to ``[B H, S, D]``."""
    from repro_torch.kernels.flash_attn.ops import _fold

    scales = [float(q.std() * k.std()) for q, k, _, _ in calls]
    layer = int(np.argmax(scales))
    q, k, v, window = calls[layer]
    calls.clear()
    return {"layer": layer, "scales": scales, "window": window,
            "qkv": tuple(_fold(t) for t in (q, k, v))}


def k5_f32_at_step_scale(pick: dict, smi: str) -> dict:
    """K5's float32 forward and backward on the q, k, v that a float32
    qwen2 step gave its layer of the largest std(q) std(k)
    (:func:`largest_scale`; dO a seeded draw of std 1): within
    ``attention_limit`` / ``attention_bwd_limit`` of the plain float32
    version and of the float64 answer (``attention_exact``).  These
    launches are checks, not the path's."""
    from repro_torch.kernels.flash_attn import (attention_bwd_limit, attention_bwd_ref,
                                                attention_exact, attention_limit,
                                                attention_lse_ref, attention_ref,
                                                flash_attention, flash_attention_backward)

    q, k, v = pick.pop("qkv")
    window, layer, scales = pick["window"], pick["layer"], pick["scales"]

    def share(got, want, lim):
        return float(((got.double() - want.double()).abs() / lim).max())

    o64, lse64 = attention_exact(q, k, v, window=window)
    want = attention_ref(q, k, v, window=window)
    lim = attention_limit(q, k, v, want, window=window)
    got = flash_attention(q, k, v, window=window)
    fwd = {"against_float32": share(got, want, lim), "against_float64": share(got, o64, lim)}
    del got, lim
    gen = torch.Generator(device=q.device).manual_seed(11)
    do = torch.randn(q.shape, generator=gen, device=q.device)
    args = (q, k, v, want, attention_lse_ref(q, k, v, window=window), do)
    lims = attention_bwd_limit(*args, window=window)
    got = flash_attention_backward(*args, window=window)
    wants = (attention_bwd_ref(*args, window=window),
             attention_bwd_ref(q.double(), k.double(), v.double(), o64, lse64,
                               do.double(), window=window))
    bwd = {key: max(share(g, w, x) for g, w, x in zip(got, ws, lims))
           for key, ws in zip(("against_float32", "against_float64"), wants)}
    s_max = float(torch.einsum("bqd,bkd->bqk", q[:1], k[:1]).abs().max()
                  / q.shape[-1] ** 0.5)
    rec = {"phase": "k5_f32_step_scale", "model": TRAIN_ARCH, "layer": layer,
           "shape": list(q.shape), "window": window,
           "q_std": float(q.std()), "k_std": float(k.std()), "v_std": float(v.std()),
           "max_abs_score_head0": s_max, "std_products_by_layer": scales,
           "forward_share_of_limit": fwd, "backward_worst_share_of_limit": bwd,
           "nvidia_smi": smi}
    emit(rec)
    del got, wants, lims, args, o64, lse64, want, q, k, v
    free_card()
    if max(list(fwd.values()) + list(bwd.values())) > 1:
        raise AssertionError(f"K5 float32 at the step's scale: {rec}")
    return rec


def train_float32(pipe, smi: str) -> dict:
    """qwen2-0.5b in float32 (``dtype="float32"``, every weight float32):
    ``make_train_step`` with remat on one microbatch of B = 2 at S = 4,096,
    a warm-up step and a timed one (host seconds to a synchronise, peak
    memory) during which the plain attention raises on the card; K5's
    float32 forward launches (the forward and remat's recompute) and its
    backward's counted, then :func:`train_grad_check` in float32.  Returns
    the launches of the phase's float32 work and, for
    :func:`k5_f32_at_step_scale`, the warm-up step's layer of the largest
    scale (:func:`largest_scale`)."""
    from dataclasses import replace

    from repro_torch.configs import get
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw

    cfg = replace(get(TRAIN_ARCH), dtype="float32", remat=True, accum_steps=1)
    L = cfg.n_layers
    before, before_bwd = k5_launches(), k5_bwd_launches()
    model = Model.init(cfg, seed=0, device="cuda", dtype=torch.float32)
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100)
    opt = adamw.init(dict(model.named_parameters()), opt_cfg)
    step = make_train_step(cfg, opt_cfg)
    batch = {k: v[:TRAIN_F32_B] for k, v in train_batch(pipe, 0).items()}
    calls = []
    off = capture_attention(calls)
    try:
        opt, _, warm_s, _, _ = timed_train_step(step, model, opt, batch)
    finally:
        off()
    pick = largest_scale(calls[:L])  # the forward's; remat's recompute repeats them
    calls.clear()
    torch.cuda.reset_peak_memory_stats()
    with plain_off_card():
        opt, m, secs, n, nb = timed_train_step(step, model, opt, batch)
    peak = torch.cuda.max_memory_allocated()
    rec = {"phase": "train_f32_step", "model": TRAIN_ARCH, "dtype": "float32",
           "param_dtypes": sorted({str(p.dtype) for p in model.parameters()}),
           "B": TRAIN_F32_B, "S": TRAIN_S, "accum_steps": 1, "remat": True,
           "warmup_s": warm_s, "seconds": secs, "tokens_per_s": TRAIN_F32_B * TRAIN_S / secs,
           "max_memory_allocated": peak, "loss": float(m["loss"]),
           "grad_norm": float(m["grad_norm"]), "k5_launches": n,
           "want_k5_launches": 2 * L, "k5_backward_launches": nb,
           "want_k5_backward_launches": L, "plain_attention_off_card": True,
           "nvidia_smi": smi}
    emit(rec)
    if not (np.isfinite(rec["loss"]) and np.isfinite(rec["grad_norm"])):
        raise AssertionError(f"float32 train step: {rec}")
    if n != 2 * L or nb != L or rec["param_dtypes"] != ["torch.float32"]:
        raise AssertionError(f"float32 train step launched K5 {n} times and its "
                             f"backward {nb}, want {2 * L} and {L}: {rec}")
    train_grad_check(model, batch, smi, phase="train_f32_grad_check",
                     limit=GRAD_RMS_LIMIT_F32)
    launches, bwd_launches = k5_launches() - before, k5_bwd_launches() - before_bwd
    del model, opt, batch
    free_card()
    return {"launches": launches, "bwd_launches": bwd_launches, "step_s": secs, "peak": peak,
            "pick": pick}


# the RMSNorm kernels (kernels/rmsnorm) alone, at the start of phase 11:
# (label, rows, d, dtype): qwen2-0.5b's training microbatch (4 x 4,096 or
# 16 x 1,024 tokens) in bf16 and as the float32 step runs it; a
# llama3.2-3b prefill of 4,096 tokens; decode's 16 rows
RMSNORM_EPS = 1e-6
RMSNORM_CASES = (("qwen2-0.5b train microbatch", 16384, 896, "bfloat16"),
                 ("qwen2-0.5b train microbatch f32", 16384, 896, "float32"),
                 ("llama3.2-3b prefill", 4096, 3072, "bfloat16"),
                 ("qwen2-0.5b decode b16", 16, 896, "bfloat16"))
RMSNORM_HOST_CALLS, RMSNORM_HOST_ROUNDS = 400, 5


def rmsnorm_launches() -> tuple:
    from repro_torch.kernels.rmsnorm import LAUNCHES

    return LAUNCHES["rmsnorm_fwd"], LAUNCHES["rmsnorm_bwd"]


def host_us(fn) -> float:
    """Median over rounds of a call's wall time in microseconds,
    ``RMSNORM_HOST_CALLS`` calls a round and a synchronise at its end: on
    small tensors, what the host takes to issue a call."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RMSNORM_HOST_ROUNDS):
        t0 = time.perf_counter()
        for _ in range(RMSNORM_HOST_CALLS):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e6 / RMSNORM_HOST_CALLS)
    return float(statistics.median(times))


def rmsnorm_case(label: str, rows: int, d: int, dtype: str, smi: str) -> dict:
    """The model's norm (``layers.rmsnorm``) on the card under autograd
    against the plain version: the forward's rounding points
    (``ref.forward_gaps``), dx and dw within ``ref.DX_LIMIT`` /
    ``ref.DW_LIMIT`` of float64, reruns bit-equal.  Device ms of a call
    with its operands out of L2 (``time_ms_cold``): the forward kernel, the
    backward's two, the eager op and autograd through it (the plain
    version), and ``torch.nn.functional.rms_norm`` both ways (the library
    yardstick, weight in x's type); the bound is the bytes each kernel must
    move once at 3.35 TB/s."""
    from repro_torch.kernels.rmsnorm import ref
    from repro_torch.models import layers

    dt, eps = getattr(torch, dtype), RMSNORM_EPS
    gen = torch.Generator("cuda").manual_seed(rows + d)
    x = torch.randn((rows, d), generator=gen, device="cuda").to(dt)
    w = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    g = torch.randn((rows, d), generator=gen, device="cuda").to(dt)
    fwd, bwd = torch.ops.repro_torch.rmsnorm_fwd, torch.ops.repro_torch.rmsnorm_bwd

    def graph(fn):
        xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
        return fn(xl, wl, eps), xl, wl

    def grads(y, xl, wl):
        return torch.autograd.grad(y, (xl, wl), g, retain_graph=True)

    before = rmsnorm_launches()
    y, xl, wl = graph(layers.rmsnorm)
    dx, dw = grads(y, xl, wl)
    y2, xl2, wl2 = graph(layers.rmsnorm)
    again = (y2, *grads(y2, xl2, wl2))
    launched = tuple(b - a for a, b in zip(before, rmsnorm_launches()))
    y, rstd = fwd(x, w, eps)
    gaps = ref.forward_gaps(x, w, eps, y, rstd)
    exact_dx, exact_dw = ref.rmsnorm_bwd_exact(x, w, rstd, g, eps)
    eager = graph(ref.rmsnorm_ref)
    e_dx, e_dw = grads(*eager)
    library = graph(lambda a, b, e: torch.nn.functional.rms_norm(a, (d,), b.to(dt), e))
    s = dt.itemsize
    fwd_bytes = 2 * rows * d * s + 4 * d + 4 * rows
    bwd_bytes = 3 * rows * d * s + 4 * d + 4 * rows + 4 * d
    rec = {"phase": "rmsnorm", "case": label, "rows": rows, "d": d, "dtype": dtype,
           "launches": list(launched), **gaps,
           "dx_rms_ratio": ref.rms_ratio(dx, exact_dx),
           "dw_rms_ratio": ref.rms_ratio(dw, exact_dw),
           "eager_dx_rms_ratio": ref.rms_ratio(e_dx, exact_dx),
           "eager_dw_rms_ratio": ref.rms_ratio(e_dw, exact_dw),
           "dx_limit": ref.DX_LIMIT[dt], "dw_limit": ref.DW_LIMIT,
           "max_abs_err": float((y.float() - eager[0].detach().float()).abs().max()),
           "reruns_equal": all(torch.equal(a, b) for a, b in zip((y, dx, dw), again)),
           "fwd_ms": time_ms_cold(lambda: fwd(x, w, eps)),
           "bwd_ms": time_ms_cold(lambda: bwd(x, w, rstd, g)),
           "fwd_ms_warm": time_ms(lambda: fwd(x, w, eps)),
           "bwd_ms_warm": time_ms(lambda: bwd(x, w, rstd, g)),
           "fwd_bound_ms": fwd_bytes / HBM_BYTES_PER_S * 1e3,
           "bwd_bound_ms": bwd_bytes / HBM_BYTES_PER_S * 1e3,
           "fwd_plain_ms": time_ms_cold(lambda: ref.rmsnorm_ref(x, w, eps)),
           "bwd_plain_ms": time_ms_cold(lambda: grads(*eager)),
           "fwd_library_ms": time_ms_cold(
               lambda: torch.nn.functional.rms_norm(x, (d,), w.to(dt), eps)),
           "bwd_library_ms": time_ms_cold(lambda: grads(*library)),
           "nvidia_smi": smi}
    emit(rec)
    if not (gaps["own_rounding"] and gaps["same_where_t_same"] and gaps["t_ulps"] <= 1
            and gaps["rstd_rel"] <= 1e-6 and rec["reruns_equal"]
            and rec["dx_rms_ratio"] <= rec["dx_limit"]
            and rec["dw_rms_ratio"] <= rec["dw_limit"] and launched == (2, 2)):
        raise AssertionError(f"RMSNorm kernels at {label}: {rec}")
    return rec


def phase_rmsnorm(smi: str) -> dict:
    """The RMSNorm kernels alone (``rmsnorm_case`` at each of
    ``RMSNORM_CASES``), then the host's microseconds a call at decode's
    shape, where the card's time is small: the model's norm forward and
    backward through the kernels and through the eager op (both under
    autograd), and the kernels' launches alone directly and through their
    operators (no autograd)."""
    from repro_torch.kernels.rmsnorm import ops, ref
    from repro_torch.models import layers

    t0 = time.perf_counter()
    recs = {c[0]: rmsnorm_case(*c, smi) for c in RMSNORM_CASES}
    free_card()
    x = torch.randn(16, 1, 896, device="cuda", dtype=torch.bfloat16).requires_grad_()
    w = torch.ones(896, device="cuda").requires_grad_()
    g = torch.randn_like(x)
    rstd = ops._launch_fwd(x.detach(), w.detach(), RMSNORM_EPS)[1]
    xd, wd = x.detach(), w.detach()

    def under_autograd(fn):
        return lambda: torch.autograd.grad(fn(x, w, RMSNORM_EPS), (x, w), g)

    host = {"kernels_fwd_bwd_autograd_us": host_us(under_autograd(layers.rmsnorm)),
            "eager_fwd_bwd_autograd_us": host_us(under_autograd(ref.rmsnorm_ref)),
            "launches_direct_us": host_us(lambda: (
                ops._launch_fwd(xd, wd, RMSNORM_EPS), ops._launch_bwd(xd, wd, rstd, g))),
            "launches_operators_us": host_us(lambda: (
                torch.ops.repro_torch.rmsnorm_fwd(xd, wd, RMSNORM_EPS),
                torch.ops.repro_torch.rmsnorm_bwd(xd, wd, rstd, g)))}
    emit({"phase": "rmsnorm_host", "shape": [16, 1, 896], "dtype": "bfloat16", **host,
          "seconds": time.perf_counter() - t0, "nvidia_smi": smi})
    return {"cases": recs, "host": host}


def phase_train(smi: str) -> dict:
    """Phase 11: the training path on the card, every launch count at 0
    just before.  K5 launches are counted per train step (2 x 24 x 4: the
    forward and remat's recompute of every layer, 4 microbatches) and over
    the phase (all from train steps, the gradient check and
    ``launch/train``); the kept launches are replayed against the plain
    version afterwards.  Returns the launches and replay records."""
    from dataclasses import replace

    from repro_torch.configs import get
    from repro_torch.kernels.flash_attn import attention_ref
    from repro_torch.kernels.pred_filter import LAUNCHES as PF_LAUNCHES
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw

    t_phase = time.perf_counter()
    rms = phase_rmsnorm(smi)
    reset_all_launches()
    cfg = replace(get(TRAIN_ARCH), remat=True, accum_steps=TRAIN_ACCUM)
    pipe, pf_calls, pf_launches = train_pipeline(cfg.vocab, smi)
    L = cfg.n_layers
    want, want_bwd = 2 * L * TRAIN_ACCUM, L * TRAIN_ACCUM
    # a microbatch's norm calls: 2 a layer, twice under remat, and the
    # final norm; the backward once a call
    want_rms = [TRAIN_ACCUM * (2 * 2 * L + 1), TRAIN_ACCUM * (2 * L + 1)]
    t0 = time.perf_counter()
    model = Model.init(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100)
    opt = adamw.init(dict(model.named_parameters()), opt_cfg)
    step = make_train_step(cfg, opt_cfg)
    per_step, per_step_bwd, runs, rms_per_step = [], [], {}, []

    torch.cuda.reset_peak_memory_stats()
    kept, undo = keep_k5_calls({0})  # microbatch 0's first layer
    try:
        rms0 = rmsnorm_launches()
        opt, m, warm_s, n, nb = timed_train_step(step, model, opt,
                                                 train_batch(pipe, 0))
        rms_per_step.append([b - a for a, b in zip(rms0, rmsnorm_launches())])
    finally:
        undo()
    per_step.append(n)
    per_step_bwd.append(nb)
    runs[0] = (warm_s, float(m["loss"]), float(m["grad_norm"]), float(m["lr"]))
    fresh = ck = None
    with plain_off_card():  # the timed steps: no plain attention on the card
        for i in range(1, 1 + TRAIN_TIMED):
            rms0 = rmsnorm_launches()
            opt, m, secs, n, nb = timed_train_step(step, model, opt,
                                                   train_batch(pipe, i))
            rms_per_step.append([b - a for a, b in zip(rms0, rmsnorm_launches())])
            per_step.append(n)
            per_step_bwd.append(nb)
            runs[i] = (secs, float(m["loss"]), float(m["grad_norm"]), float(m["lr"]))
            if i == TRAIN_CKPT_AFTER:
                fresh, fresh_opt, ck = train_checkpoint_save(model, opt, i)
    peak = torch.cuda.max_memory_allocated()
    secs = [runs[i][0] for i in range(1, 1 + TRAIN_TIMED)]
    med = statistics.median(secs)
    tokens = TRAIN_B * TRAIN_S
    flops = train_flops(model, tokens, TRAIN_B)
    params = sum(p.numel() for p in model.parameters())
    losses = [runs[i][1] for i in sorted(runs)]
    emit({"phase": "train_step", "model": TRAIN_ARCH, "layers": L,
          "params": params, "param_dtypes": sorted({str(p.dtype) for p in
                                                    model.parameters()}),
          "B": TRAIN_B, "S": TRAIN_S, "accum_steps": TRAIN_ACCUM,
          "microbatch": TRAIN_B // TRAIN_ACCUM, "remat": True, "init_s": init_s,
          "warmup_s": warm_s, "seconds": secs, "seconds_median": med,
          "tokens_per_step": tokens, "tokens_per_s": tokens / med,
          "model_flops": flops,
          "flops_formula": "6 x N x tokens + 3 x A + remat's extra forward "
                           "(2 x N_blocks x tokens + A); N = parameters but "
                           "the embedding table, A = 2 x 2 H D x unmasked "
                           "(query, key) pairs x layers x sequences",
          "flop_rate": flops / med, "share_of_bf16_peak": flops / med / BF16_FLOPS_PER_S,
          "max_memory_allocated": peak, "losses": losses,
          "grad_norms": [runs[i][2] for i in sorted(runs)],
          "lrs": [runs[i][3] for i in sorted(runs)],
          "k5_launches_per_step": per_step, "want_k5_launches_per_step": want,
          "k5_backward_launches_per_step": per_step_bwd,
          "want_k5_backward_launches_per_step": want_bwd,
          "rmsnorm_launches_per_step": rms_per_step,
          "want_rmsnorm_launches_per_step": want_rms,
          "plain_attention_off_card": True, "nvidia_smi": smi})
    if any(n != want_rms for n in rms_per_step):
        raise AssertionError(f"train steps launched the RMSNorm kernels {rms_per_step} "
                             f"times (forward, backward), want {want_rms}")
    if not all(np.isfinite(r[1]) and np.isfinite(r[2]) for r in runs.values()):
        raise AssertionError(f"train step: non-finite loss or gradient norm {runs}")

    # step TRAIN_CKPT_AFTER + 1 again, from the restored state
    before, before_bwd = k5_launches(), k5_bwd_launches()
    t0 = time.perf_counter()
    with plain_off_card():
        _, _, restored = step(fresh, fresh_opt, train_batch(pipe, TRAIN_CKPT_AFTER + 1))
    restored_loss = float(restored["loss"])
    restored_s = time.perf_counter() - t0
    per_step.append(k5_launches() - before)
    per_step_bwd.append(k5_bwd_launches() - before_bwd)
    kept_loss = runs[TRAIN_CKPT_AFTER + 1][1]
    ck.update(phase="train_checkpoint", restored_step=TRAIN_CKPT_AFTER + 1,
              restored_step_s=restored_s, loss_restored=restored_loss,
              loss_uninterrupted=kept_loss, loss_rtol=CKPT_LOSS_RTOL,
              nvidia_smi=smi)
    emit(ck)
    del fresh, fresh_opt, restored
    free_card()
    if abs(ck["loss_restored"] - kept_loss) > CKPT_LOSS_RTOL * abs(kept_loss):
        raise AssertionError(f"restored step's loss {ck['loss_restored']} vs "
                             f"{kept_loss}")

    batch = train_batch(pipe, 0)
    grad = train_grad_check(model, batch, smi)
    del model, opt, batch
    free_card()
    f32 = train_float32(pipe, smi)
    main_rec = train_main(smi)
    free_card()

    launches, bwd_launches = k5_launches(), k5_bwd_launches()
    counted = (sum(per_step) + grad["k5_launches"] + f32["launches"]
               + main_rec["k5_launches"])
    counted_bwd = (sum(per_step_bwd) + grad["k5_backward_launches"]
                   + f32["bwd_launches"] + main_rec["k5_backward_launches"])
    main_want = 6 * L  # 6 steps, one microbatch, remat off
    emit({"phase": "train_launches", "k5_launches": launches,
          "k5_launches_of_train_steps": counted, "k5_per_step": per_step,
          "want_per_step": want, "k5_grad_check": grad["k5_launches"],
          "k5_float32_step": f32["launches"], "k5_backward_float32_step": f32["bwd_launches"],
          "k5_launch_train": main_rec["k5_launches"],
          "k5_backward_launches": bwd_launches,
          "k5_backward_launches_of_train_steps": counted_bwd,
          "k5_backward_per_step": per_step_bwd, "want_backward_per_step": want_bwd,
          "k5_backward_launch_train": main_rec["k5_backward_launches"],
          "pred_filter": dict(PF_LAUNCHES)})
    if any(n != want for n in per_step) or any(n != want_bwd for n in per_step_bwd):
        raise AssertionError(f"train steps launched K5 {per_step} and its "
                             f"backward {per_step_bwd}, want {want} and {want_bwd}")
    if launches != counted or main_rec["k5_launches"] != main_want or \
            bwd_launches != counted_bwd or main_rec["k5_backward_launches"] != 6 * L:
        raise AssertionError(f"K5 launched {launches} / {bwd_launches} times in "
                             f"phase 11, its train steps account for {counted} / "
                             f"{counted_bwd}")
    k5_f32_at_step_scale(f32.pop("pick"), smi)

    replays = []
    t0 = time.perf_counter()
    for i in sorted(kept):
        layer = i  # microbatch 0's forward: launch i is layer i
        rec = replay_k5(TRAIN_ARCH, layer, kept[i], smi, path="train step",
                        phase="train_kernel", backward=True, microbatch=0)
        q, k, v, window, _ = kept[i]
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        g = torch.randn_like(q)

        def autograd_backward():
            with torch.enable_grad():
                a = attention_ref(*leaves, window=window)
                return torch.autograd.grad(a, leaves, g)

        # what the node ran on the card before the backward kernel
        rec["backward"]["backward_autograd_plain_ms"] = time_ms(
            autograd_backward, reps=3, inner=1)
        emit({"phase": "train_k5_backward", "case": rec["backward"]["case"],
              **{key: rec["backward"][key] for key in (
                  "backward_kernel_ms", "backward_plain_ms",
                  "backward_autograd_plain_ms", "backward_library_ms",
                  "bound_ms", "bound_by", "rms_ratio")},
              "per_step": L * TRAIN_ACCUM, "nvidia_smi": smi})
        replays.append(rec)
        del leaves, g
        free_card()
    kept.clear()
    emit({"phase": "train_k5_replay", "seconds": time.perf_counter() - t0})
    pf = replay_launches(pf_calls, "train_pipeline",
                         lambda where, args: (variant(args),))
    pf_calls.clear()
    emit({"phase": "train_total", "seconds": time.perf_counter() - t_phase,
          "k5_launches": launches})
    return {"launches": launches, "bwd_launches": bwd_launches,
            "rmsnorm": rms, "rmsnorm_per_step": want_rms,
            "rmsnorm_launches": list(rmsnorm_launches()),
            "replays": replays, "per_step": want, "per_step_bwd": want_bwd,
            "first_loss": runs[0][1], "step_s": med, "model_flops": flops,
            "pred_filter": pf_launches, "pred_filter_recs": pf}


# --------------------------------------------------------------------------- #
# phase 12: the same paths over a DeviceMesh
# --------------------------------------------------------------------------- #
MESH_PREFILL_ARCH = "llama3.2-3b"
MESH_DECODE_B, MESH_DECODE_PROMPT, MESH_DECODE_GEN = 2, 16, 16
MESH_QUERIES = ("q3", "q12")
MESH_CKPT_DIR = os.path.join(ROOT, "build", "chip_smoke_mesh_ckpt")
# the sharded step against the unsharded one from the same seed and batch:
# one rank runs the same kernels on the same tensors, so the loss and the
# clip norm agree to 1e-5 and every weight to an eighth of the step's
# learning rate (a first AdamW step moves a weight by about lr whatever
# its gradient, so a wrong, zero or cut-off gradient moves it by lr or 2 lr)
MESH_RTOL, MESH_WEIGHT_LR_SHARE = 1e-5, 1 / 8


def mesh_train(mesh, smi: str, phase11_loss=None) -> dict:
    """qwen2-0.5b at phase 11's shape: one unsharded step (the reference),
    then ``build_train(fsdp=True)``: a warm-up step held to it and 5 timed
    steps; the sharded state checkpointed and restored.  Returns the
    launches, the replay record and the record of the steps."""
    from dataclasses import replace

    from repro_torch.checkpoint.manager import (CheckpointManager, flatten,
                                                train_state, unflatten)
    from repro_torch.compat import DTensor
    from repro_torch.configs import get
    from repro_torch.data.pipeline import LineageDataPipeline, synth_corpus
    from repro_torch.distrib.sharding import layout_of
    from repro_torch.launch.steps import build_train, make_train_step
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw

    cfg = replace(get(TRAIN_ARCH), remat=True, accum_steps=TRAIN_ACCUM)
    L = cfg.n_layers
    want, want_bwd = 2 * L * TRAIN_ACCUM, L * TRAIN_ACCUM
    catalog, tokens = synth_corpus(n_docs=TRAIN_DOCS, vocab=cfg.vocab, seed=0)
    pipe = LineageDataPipeline(catalog, tokens, seq_len=TRAIN_S,
                               batch=TRAIN_B, seed=0, device="cuda")
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100)
    batch0 = train_batch(pipe, 0)

    ref = Model.init(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    _, m_ref, ref_s, ref_launches, ref_bwd = timed_train_step(
        make_train_step(cfg, opt_cfg), ref,
        adamw.init(dict(ref.named_parameters()), opt_cfg), batch0)
    ref_w = [p.detach() for p in ref.parameters()]
    ref_loss, lr = float(m_ref["loss"]), float(m_ref["lr"])
    ref_norm = float(m_ref["grad_norm"])
    del ref, m_ref
    free_card()

    model = Model.init(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    opt = adamw.init(dict(model.named_parameters()), opt_cfg)
    step, _ = build_train(mesh, cfg, ShapeConfig("train_4k", TRAIN_S, TRAIN_B,
                                                 "train"), opt_cfg, fsdp=True)
    torch.cuda.synchronize()
    kept, undo = keep_k5_calls({0})
    checked = check_k5_calls("mesh train step", smi)  # every launch of it
    before, before_bwd = k5_launches(), k5_bwd_launches()
    t0 = time.perf_counter()
    try:
        model, opt, m = step(model, opt, batch0)
        torch.cuda.synchronize()
    finally:
        check = checked()
        undo()
    warm_s, per_step = time.perf_counter() - t0, [k5_launches() - before]
    per_step_bwd = [k5_bwd_launches() - before_bwd]
    torch.cuda.reset_peak_memory_stats()  # over the timed steps
    loss, norm = float(m["loss"]), float(m["grad_norm"])
    diffs = [float((a.detach().full_tensor().float() - b.float()).abs().max())
             for a, b in zip(model.parameters(), ref_w)]
    exact = sum(d == 0 for d in diffs)
    del ref_w
    runs = []
    with plain_off_card():  # the timed steps: no plain attention on the card
        for i in range(1, 1 + TRAIN_TIMED):
            opt, mi, secs, n, nb = timed_train_step(step, model, opt,
                                                    train_batch(pipe, i))
            runs.append((secs, float(mi["loss"]), float(mi["grad_norm"])))
            per_step.append(n)
            per_step_bwd.append(nb)
    med = statistics.median(r[0] for r in runs)
    placements = sorted({str(tuple(p.placements)) for p in model.parameters()})
    rec = {"phase": "mesh_train_step", "model": TRAIN_ARCH,
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "fsdp": True,
           "B": TRAIN_B, "S": TRAIN_S, "accum_steps": TRAIN_ACCUM,
           "remat": True, "warmup_s": warm_s,
           "seconds": [r[0] for r in runs], "seconds_median": med,
           "tokens_per_s": TRAIN_B * TRAIN_S / med,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "losses": [loss] + [r[1] for r in runs],
           "grad_norms": [norm] + [r[2] for r in runs],
           "unsharded_loss": ref_loss, "unsharded_grad_norm": ref_norm,
           "unsharded_step_s": ref_s, "phase11_first_loss": phase11_loss,
           "rtol": MESH_RTOL, "lr": lr, "weights_max_abs_diff": max(diffs),
           "weights_tol": MESH_WEIGHT_LR_SHARE * lr,
           "leaves_bit_identical": exact, "leaves": len(diffs),
           "placements": placements,
           "k5_launches_per_step": per_step, "want_k5_launches_per_step": want,
           "unsharded_k5_launches": ref_launches,
           "k5_backward_launches_per_step": per_step_bwd,
           "want_k5_backward_launches_per_step": want_bwd,
           "unsharded_k5_backward_launches": ref_bwd,
           "plain_attention_off_card": True,
           "warmup_k5_checked": check["checked"], "nvidia_smi": smi}
    emit(rec)
    if abs(loss - ref_loss) > MESH_RTOL * abs(ref_loss) or \
            abs(norm - ref_norm) > MESH_RTOL * abs(ref_norm) or \
            not lr > 0 or max(diffs) > MESH_WEIGHT_LR_SHARE * lr:
        raise AssertionError(f"sharded step against unsharded: loss {loss} vs "
                             f"{ref_loss}, grad norm {norm} vs {ref_norm}, "
                             f"weights {max(diffs)} at lr {lr}")
    if any(n != want for n in per_step) or ref_launches != want or \
            check["checked"] != want or ref_bwd != want_bwd or \
            any(n != want_bwd for n in per_step_bwd):
        raise AssertionError(f"mesh train steps launched K5 {per_step} and its "
                             f"backward {per_step_bwd}, unsharded {ref_launches} "
                             f"and {ref_bwd}, want {want} and {want_bwd}")
    if not all(np.isfinite(r[1]) for r in runs):
        raise AssertionError(f"mesh train: non-finite loss {runs}")

    import shutil

    shutil.rmtree(MESH_CKPT_DIR, ignore_errors=True)
    state = train_state(model, opt)
    ckpt = CheckpointManager(MESH_CKPT_DIR, keep=1)
    t0 = time.perf_counter()
    ckpt.save(1 + TRAIN_TIMED, state)
    save_s = time.perf_counter() - t0
    layouts = unflatten(state, [layout_of(x) if isinstance(x, DTensor) else None
                                for _, x in flatten(state)])
    t0 = time.perf_counter()
    got_step, back = ckpt.restore(state, shardings=layouts, device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same = [type(x) is type(y) and x.dtype == y.dtype and (
        x.placements == y.placements and torch.equal(x.to_local(), y.to_local())
        if isinstance(x, DTensor) else torch.equal(x, y))
        for (_, x), (_, y) in zip(flatten(state), flatten(back))]
    shutil.rmtree(MESH_CKPT_DIR, ignore_errors=True)
    ck = {"phase": "mesh_checkpoint", "step": got_step, "save_s": save_s,
          "restore_s": restore_s, "leaves": len(same),
          "dtensor_leaves": sum(isinstance(x, DTensor) for _, x in flatten(state)),
          "bit_identical": all(same), "nvidia_smi": smi}
    emit(ck)
    if got_step != 1 + TRAIN_TIMED or not all(same):
        raise AssertionError(f"mesh checkpoint: {sum(same)} of {len(same)} "
                             f"leaves identical")
    del model, opt, state, back, pipe
    free_card()
    return {"launches": sum(per_step) + ref_launches,
            "bwd_launches": sum(per_step_bwd) + ref_bwd, "kept": kept,
            "per_step": per_step[0], "per_step_bwd": per_step_bwd[0],
            "record": rec}


def mesh_launch_train(mesh, smi: str) -> dict:
    """``launch/train.py``'s step at its own shape (``TRAIN_MAIN_ARGS``:
    qwen2-0.5b, B = 4, S = 512, remat off): ``make_train_step``, which it
    ran unsharded before, against ``build_train(fsdp=False)`` on the
    one-rank mesh, which it runs now; two models from one seed, the same
    batches, the two steps taken in turn.  Returns the K5 launches."""
    from dataclasses import replace

    from repro_torch.configs import get
    from repro_torch.launch.steps import build_train, make_train_step
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw

    arg = dict(zip(TRAIN_MAIN_ARGS[::2], TRAIN_MAIN_ARGS[1::2]))
    B, S = int(arg["--batch"]), int(arg["--seq"])
    cfg = replace(get(TRAIN_ARCH), remat=False)
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=100)
    gen = torch.Generator(device="cuda").manual_seed(11)
    steps = {"unsharded": make_train_step(cfg, opt_cfg),
             "mesh": build_train(mesh, cfg, ShapeConfig("cli", S, B, "train"),
                                 opt_cfg, fsdp=False)[0]}
    state = {}
    for name in steps:
        m = Model.init(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
        state[name] = [m, adamw.init(dict(m.named_parameters()), opt_cfg)]
    secs, losses = {k: [] for k in steps}, {k: [] for k in steps}
    launches = bwd_launches = 0
    for i in range(1 + TRAIN_TIMED):  # the first, a warm-up, untimed
        toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
        for name, step in steps.items():
            torch.cuda.synchronize()
            before, before_bwd = k5_launches(), k5_bwd_launches()
            t0 = time.perf_counter()
            model, opt, m = step(*state[name], {"tokens": toks, "labels": toks})
            loss = float(m["loss"])  # waits for the step, as launch/train does
            dt = time.perf_counter() - t0
            launches += k5_launches() - before
            bwd_launches += k5_bwd_launches() - before_bwd
            state[name] = [model, opt]
            losses[name].append(loss)
            if i:
                secs[name].append(dt)
    med = {k: statistics.median(v) for k, v in secs.items()}
    rec = {"phase": "mesh_launch_train_step", "model": TRAIN_ARCH, "B": B,
           "S": S, "remat": False, "mesh": dict(zip(mesh.mesh_dim_names,
                                                   mesh.shape)),
           "unsharded_s": secs["unsharded"], "mesh_s": secs["mesh"],
           "unsharded_s_median": med["unsharded"], "mesh_s_median": med["mesh"],
           "mesh_over_unsharded": med["mesh"] / med["unsharded"],
           "losses": losses, "k5_launches": launches,
           "k5_backward_launches": bwd_launches, "nvidia_smi": smi}
    emit(rec)
    del state, steps
    free_card()
    if any(abs(a - b) > MESH_RTOL * abs(a) for a, b in
           zip(losses["unsharded"], losses["mesh"])):
        raise AssertionError(f"launch/train's step on the mesh: {losses}")
    if bwd_launches != launches:  # remat off: one backward a forward
        raise AssertionError(f"launch/train's steps: {launches} K5 launches, "
                             f"{bwd_launches} backward")
    return {"launches": launches, "bwd_launches": bwd_launches, "record": rec}


def mesh_prefill_decode(mesh, smi: str) -> dict:
    """llama3.2-3b in bf16: ``build_prefill`` at S = 4,096 against
    ``Model.prefill``; ``build_decode`` against ``decode_step`` over 16
    prompt tokens and 16 greedy ones."""
    from repro_torch.configs import get
    from repro_torch.kernels.flash_attn import rms_ratio
    from repro_torch.launch.steps import (build_decode, build_prefill,
                                          param_shardings, shard_model)
    from repro_torch.models.config import ShapeConfig

    cfg = get(MESH_PREFILL_ARCH)
    L = cfg.n_layers
    model = lm_model(MESH_PREFILL_ARCH, smi)
    gen = torch.Generator(device="cuda").manual_seed(12)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, LM_PREFILL_S),
                                     generator=gen, device="cuda")}
    want, plain_s, plain_n = timed_prefill(lambda m, b: m.prefill(b), model, batch)
    sharded = shard_model(model, param_shardings(mesh, cfg, fsdp=False)[2])
    step, _ = build_prefill(mesh, cfg, ShapeConfig("prefill_4k", LM_PREFILL_S,
                                                   1, "prefill"))
    kept, undo = keep_k5_calls({0})
    checked = check_k5_calls("mesh prefill", smi)  # every launch of it
    try:
        got, warm_s, warm_n = timed_prefill(step, sharded, batch)
    finally:
        check = checked()
        undo()
    runs = [timed_prefill(step, sharded, batch) for _ in range(3)]
    launches = [warm_n] + [n for _, _, n in runs]
    v = cfg.vocab
    rms = rms_ratio(got[..., :v], want[..., :v])
    top1 = bool(torch.equal(got[..., :v].argmax(-1), want[..., :v].argmax(-1)))
    pre = {"phase": "mesh_prefill", "model": cfg.name, "B": 1, "S": LM_PREFILL_S,
           "unsharded_s": plain_s, "warmup_s": warm_s,
           "seconds": [t for _, t, _ in runs],
           "seconds_median": statistics.median(t for _, t, _ in runs),
           "rms_ratio": rms, "rms_limit": DECODE_RMS_LIMIT, "same_top1": top1,
           "bit_identical": bool(torch.equal(got, want)),
           "k5_launches_per_call": launches, "unsharded_k5_launches": plain_n,
           "nvidia_smi": smi}
    emit(pre)
    if rms > DECODE_RMS_LIMIT or not top1 or any(n != L for n in launches) \
            or check["checked"] != L:
        raise AssertionError(f"mesh prefill: {pre}")
    del want, got, runs

    B, n_in, n_gen = MESH_DECODE_B, MESH_DECODE_PROMPT, MESH_DECODE_GEN
    shape = ShapeConfig("decode", n_in + n_gen, B, "decode")
    decode, _ = build_decode(mesh, cfg, shape)
    prompt = torch.randint(0, cfg.vocab, (B, n_in), generator=gen, device="cuda")

    def run(fn, m):
        st = model.init_decode_state(B, n_in + n_gen)
        out, logits, t0 = [], [], time.perf_counter()
        tok = prompt[:, :1]
        for i in range(n_in + n_gen - 1):
            lg, st = fn(m, st, tok)
            if i + 1 < n_in:
                tok = prompt[:, i + 1:i + 2]
            else:
                tok = lg[..., :v].argmax(-1)
                out.append(tok)
                logits.append(lg)
        torch.cuda.synchronize()
        return torch.cat(out, 1), torch.cat(logits, 1), time.perf_counter() - t0

    toks1, lg1, s1 = run(lambda m, st, t: m.decode_step(st, t), model)
    toks2, lg2, s2 = run(decode, sharded)
    dec = {"phase": "mesh_decode", "model": cfg.name, "B": B,
           "prompt": n_in, "generated": int(toks1.shape[1]),
           "same_tokens": bool(torch.equal(toks1, toks2)),
           "rms_ratio": rms_ratio(lg2[..., :v], lg1[..., :v]),
           "unsharded_s": s1, "sharded_s": s2,
           "sharded_tokens_per_s": B * (n_in + n_gen - 1) / s2,
           "unsharded_tokens_per_s": B * (n_in + n_gen - 1) / s1,
           "nvidia_smi": smi}
    emit(dec)
    if not dec["same_tokens"]:
        raise AssertionError(f"mesh decode: {dec}")
    del model, sharded
    free_card()
    return {"launches": sum(launches) + plain_n, "kept": kept,
            "per_prefill": launches[0],
            "prefill": pre, "decode": dec}


def mesh_lineage(mesh, smi: str, sf: float, stage: dict) -> None:
    """``distributed_refine`` over the process mesh for q3 and q12 row 0 at
    ``sf``, on the card, each answer identical to numpy's
    ``query_iterative`` (``stage`` names the query for the kept K1/K2
    launches)."""
    from repro_torch.core import PredTrace, ScanEngine, distributed_refine
    from repro_torch.kernels.pred_filter import LAUNCHES
    from repro_torch.tpch import ALL_QUERIES, generate

    t0 = time.perf_counter()
    db = generate(sf=sf, seed=1)
    gen_s = time.perf_counter() - t0
    for q in MESH_QUERIES:
        pt = PredTrace(db, ALL_QUERIES[q](db), scan_engine=ScanEngine("numpy"))
        pt.infer()
        pt.run()
        want = pt.query_iterative(0)
        binding = pt._output_binding(0, pt.iter_plan.out_params)
        stage.update(query=q, name="distributed_refine over the process mesh")
        eng = ScanEngine("torch", device="cuda")
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        ans = distributed_refine(pt.iter_plan, db, binding, mesh=mesh,
                                 engine=eng)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        same = sorted(ans.lineage) == sorted(want.lineage) and all(
            np.array_equal(np.sort(ans.lineage[t]), np.sort(want.lineage[t]))
            for t in want.lineage)
        rec = {"phase": "mesh_lineage", "query": q, "row": 0, "sf": sf,
               "seconds": secs, "iterations": ans.detail["iterations"],
               "identical_to_numpy": same, "device_scans": eng.stats.device_scans,
               "launches": {k: LAUNCHES[k] - before[k] for k in LAUNCHES},
               "lineage_rows": {t: len(x) for t, x in ans.lineage.items()},
               "dbgen_s": gen_s, "nvidia_smi": smi}
        emit(rec)
        pt.close()
        if not same or eng.stats.device_scans < 1:
            raise AssertionError(f"mesh lineage: {rec}")
    del db


def phase_mesh(smi: str, sf: float, phase11_loss=None) -> dict:
    """Phase 12: the training, serving and lineage paths over a
    ``DeviceMesh``, every launch count at 0 just before; the kept K5 and
    K1/K2 launches replayed against the plain version afterwards."""
    from repro_torch.kernels.pred_filter import LAUNCHES as PF_LAUNCHES
    from repro_torch.launch.mesh import make_host_mesh

    t_phase = time.perf_counter()
    mesh = make_host_mesh(data=int(os.environ.get("WORLD_SIZE", "1")), model=1)
    emit({"phase": "mesh", "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
          "device_type": mesh.device_type,
          "backend": torch.distributed.get_backend(), "nvidia_smi": smi})
    pf_calls, stage = [], {"query": "mesh", "name": "train pipeline"}
    reset_all_launches()
    unwrap = capture_batch_launches(pf_calls, stage)  # every K1/K2 launch
    try:
        train = mesh_train(mesh, smi, phase11_loss)
        cli = mesh_launch_train(mesh, smi)
        serve = mesh_prefill_decode(mesh, smi)
        mesh_lineage(mesh, smi, sf, stage)
    finally:
        unwrap()
    launches, pf_launches = k5_launches(), dict(PF_LAUNCHES)
    bwd_launches = k5_bwd_launches()
    counted = train["launches"] + cli["launches"] + serve["launches"]
    counted_bwd = train["bwd_launches"] + cli["bwd_launches"]
    emit({"phase": "mesh_launches", "k5_launches": launches,
          "k5_launches_of_steps": counted, "k5_backward_launches": bwd_launches,
          "k5_backward_launches_of_steps": counted_bwd,
          "pred_filter": pf_launches})
    if launches != counted or bwd_launches != counted_bwd:
        raise AssertionError(f"K5 launched {launches} / {bwd_launches} times in "
                             f"phase 12, its steps account for {counted} / "
                             f"{counted_bwd}")
    if pf_launches["cmp"] < 1 or len(pf_calls) != pf_launches["cmp"] + pf_launches["sets"]:
        raise AssertionError(f"mesh lineage: {len(pf_calls)} kept calls, "
                             f"launches {pf_launches}")
    replays = [replay_k5(TRAIN_ARCH, 0, train["kept"][0], smi,
                         path="mesh train step", phase="mesh_kernel"),
               replay_k5(MESH_PREFILL_ARCH, 0, serve["kept"][0], smi,
                         path="mesh prefill", phase="mesh_kernel")]
    train["kept"].clear()
    serve["kept"].clear()
    pf = replay_launches(pf_calls, "mesh_lineage",
                         lambda where, args: (variant(args),))
    pf_calls.clear()
    free_card()
    emit({"phase": "mesh_total", "seconds": time.perf_counter() - t_phase,
          "k5_launches": launches})
    return {"launches": launches, "bwd_launches": bwd_launches,
            "replays": replays, "pred_filter": pf_launches,
            "pred_filter_recs": pf, "per_step": train["per_step"],
            "per_step_bwd": train["per_step_bwd"],
            "per_prefill": serve["per_prefill"]}


# --------------------------------------------------------------------------- #
# phase 13: the dry run's bound of phase 11's step
# --------------------------------------------------------------------------- #


def close_process_group() -> None:
    """Ends the one-rank process group ``launch/train`` and phase 12's mesh
    started, if one is running."""
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def phase_bound(smi: str, train: dict) -> dict:
    """Phase 13: ``launch/dryrun.py``'s trace of phase 11's step
    (qwen2-0.5b, B = 8 at S = 4,096, remat, 4 microbatches) on a one-rank
    mesh of a fake process group, on fake tensors (nothing runs on the
    card), at the dry run's two analysis depths extrapolated to 24 layers:
    its compute, memory and collective terms at the H100's constants
    (``launch/roofline.py``), the bound, and the bound over phase 11's
    measured step.  Needs no other process group running."""
    from dataclasses import replace

    from repro_torch.configs import get
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.config import ShapeConfig

    cfg = replace(get(TRAIN_ARCH), remat=True, accum_steps=TRAIN_ACCUM)
    shape = ShapeConfig("train_4k", TRAIN_S, TRAIN_B, "train")
    t0 = time.perf_counter()
    traced, rf, trace_s = dryrun.trace_cell(
        cfg, shape, 1, lambda: make_host_mesh(1, 1, device_type="cpu"),
        depths=dryrun.ANALYSIS_LAYERS)
    secs = time.perf_counter() - t0
    rec = {"phase": "bound", "model": TRAIN_ARCH, "B": TRAIN_B, "S": TRAIN_S,
           "accum_steps": TRAIN_ACCUM, "remat": True, "mesh": {"data": 1, "model": 1},
           "depths": list(dryrun.ANALYSIS_LAYERS), "compute_s": rf.compute_s,
           "memory_s": rf.memory_s, "collective_s": rf.collective_s,
           "dominant": rf.dominant, "bound_s": rf.bound_s, "flops": rf.flops,
           "bytes_accessed": rf.bytes_accessed,
           "per_device_bytes": rf.per_device_hbm_bytes,
           "constants": {"peak_flops": roofline.PEAK_FLOPS,
                         "hbm_bw": roofline.HBM_BW, "link_bw": roofline.LINK_BW},
           "measured_step_s": train["step_s"],
           "bound_over_step": rf.bound_s / train["step_s"],
           "phase11_model_flops": train["model_flops"],
           "trace_s": trace_s, "seconds": secs, "nvidia_smi": smi}
    emit(rec)
    if not (rf.flops > 0 and rf.bytes_accessed > 0 and 0 < rec["bound_over_step"]):
        raise AssertionError(f"phase 13: {rec}")
    return rec


# --------------------------------------------------------------------------- #
def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=1.0,
                    help="TPC-H scale factor of the main-path phase")
    ap.add_argument("--only-lm", action="store_true",
                    help="phases 1, 2 and 10 alone, and no result line")
    ap.add_argument("--only-train", action="store_true",
                    help="phases 1, 2, 11 and 13 alone, and no result line")
    ap.add_argument("--only-mesh", action="store_true",
                    help="phases 1, 2 and 12 alone, and no result line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device; the port's smoke run needs one")
    for mod in list(sys.modules):
        if mod.split(".")[0] in ("jax", "repro"):
            sys.exit(f"chip_smoke.py: {mod} must not be imported")
    # the port must be importable before anything is printed
    from repro_torch.kernels import _build

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
    phase_k5_bwd_build(lib, smi)

    # float32 products of the plain versions stay in float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.only_lm or args.only_train or args.only_mesh:
        if args.only_lm:
            phase_lm(smi, None)
        elif args.only_train:
            train = phase_train(smi)
            close_process_group()  # launch/train's; phase 13 starts its own
            phase_bound(smi, train)
        else:
            phase_mesh(smi, args.sf)
        emit({"phase": "total", "seconds": time.perf_counter() - t_start})
        return
    n_lineitem = 6_001_215  # TPC-H sf-1 lineitem rows
    k1, k2 = phase_kernels(n_lineitem)
    phase_device_ratio(smi)
    main_launches, db, calls = phase_main_path(args.sf)
    main_recs = phase_main_path_kernels(calls)
    del calls
    phase_serve(db, smi)
    phase_partition(db, smi)
    phase_baselines(db, smi)
    t6 = time.perf_counter()
    inp = entry_inputs(db)
    del db
    out, entry_launches, secs = drive_entry_points(inp)
    emit({"phase": "entry_launches", "launches": entry_launches,
          "seconds": secs})
    check_entry_outputs(inp, out)
    del out
    recs = phase_entry_kernels(inp, secs, smi)
    emit({"phase": "entry_points_total", "seconds": time.perf_counter() - t6})
    del inp
    free_card()
    lm = phase_lm(smi, recs["flash_attention"])
    train = phase_train(smi)
    mesh = phase_mesh(smi, args.sf, train["first_loss"])
    close_process_group()  # phases 11 and 12's; phase 13 starts its own
    phase_bound(smi, train)
    if any(m in sys.modules for m in ("jax", "repro")):
        raise AssertionError("jax or the reference package was imported")

    def entry(name, recs, variant, launches, source=SOURCE, pick=0, also=(),
              later=None):
        r = recs[pick]
        more = {}
        if later:  # phase 5's main path, then phases 11 and 12
            more = {"launches_by_phase": {
                "main_path": int(launches[variant]),
                **{k: int(v[variant]) for k, v in later.items()}}}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": REPLACES[variant],
                "launches": int(launches[variant]) + sum(
                    int(v[variant]) for v in (later or {}).values()), **more,
                "max_abs_err": max(x["max_abs_err"] for x in [*recs, *also]),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "shape": r["case"]}

    def k5_entry(lm, train, mesh, entry_recs, entry_launches, source):
        """K5 on the LM paths (phases 10, 11 and 12): its launches there,
        its time at the first replayed llama3.2-3b layer; the training
        shape, the mesh's launches and phase 6's cases beside."""
        r = lm["replays"][0]
        replays = lm["replays"] + train["replays"] + mesh["replays"]
        return {"name": "flash_attention (K5)", "route": "cuda",
                "source": source, "replaces": REPLACES["flash_attention"],
                "launches": int(lm["launches"]) + int(train["launches"])
                + int(mesh["launches"]),
                "launches_by_phase": {"lm": int(lm["launches"]),
                                      "train": int(train["launches"]),
                                      "mesh": int(mesh["launches"])},
                "launches_per_prefill": lm["per_prefill"],
                "launches_per_train_step": train["per_step"],
                "mesh_launches_per_train_step": mesh["per_step"],
                "mesh_launches_per_prefill": mesh["per_prefill"],
                "entry_launches": int(entry_launches["flash_attention"]),
                "max_abs_err": max(x["max_abs_err"]
                                   for x in [*replays, *entry_recs]),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "shape": r["case"],
                "model_path_ms": {x["case"]: x["ms"] for x in replays},
                "mesh_ms": {x["case"]: x["ms"] for x in mesh["replays"]},
                "entry_ms": {x["case"]: x["ms"] for x in entry_recs},
                "head_dim_cases": {
                    k: {f: r[f] for f in ("case", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "max_abs_err", "share_of_limit",
                                          "rms_ratio")}
                    for k, r in lm["head_dims"].items()}}

    def k5_backward_entry(lm, train, mesh, entry_recs, source):
        """K5's backward kernel on the training paths (phases 10, 11 and
        12): its launches there, its time on phase 11's first replayed
        layer (qwen2-0.5b's training shape); every head dim's case (phase
        10's replays and phase 6's cases) beside."""
        trained = [x["backward"] for x in train["replays"]]
        cases = [x["backward"] for x in lm["replays"] if "backward" in x]
        r = trained[0]
        return {"name": "flash_attention_backward (K5 backward)",
                "route": "cuda", "source": source,
                "replaces": REPLACES["flash_attention"],
                "replaces_note": "the reference has no backward kernel: JAX "
                                 "differentiates its plain attention "
                                 "(src/repro/kernels/flash_attn/ref.py:11)",
                "launches": int(lm["bwd_launches"]) + int(train["bwd_launches"])
                + int(mesh["bwd_launches"]),
                "launches_by_phase": {"lm": int(lm["bwd_launches"]),
                                      "train": int(train["bwd_launches"]),
                                      "mesh": int(mesh["bwd_launches"])},
                "launches_per_train_step": train["per_step_bwd"],
                "mesh_launches_per_train_step": mesh["per_step_bwd"],
                "max_abs_err": max(x["max_abs_err"]
                                   for x in [*trained, *cases, *entry_recs]),
                "ms": r["backward_kernel_ms"], "plain_ms": r["backward_plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["backward_library_ms"], "shape": r["case"],
                "autograd_plain_ms": r["backward_autograd_plain_ms"],
                "rms_ratio": r["rms_ratio"],
                "head_dim_cases": [
                    {f: x[f] for f in ("case", "backward_kernel_ms",
                                       "backward_plain_ms", "backward_library_ms",
                                       "bound_ms", "bound_by", "max_abs_err",
                                       "rms_ratio")}
                    for x in [*cases, *entry_recs]]}

    def rmsnorm_entries(train, source):
        """The RMSNorm kernels (no TPU kernel: the reference's norm is plain
        ``jnp``): phase 11's launches, each way's time at qwen2-0.5b's
        training microbatch, every case beside."""
        cases = train["rmsnorm"]["cases"]
        r = cases[RMSNORM_CASES[0][0]]
        return [{"name": name, "route": "cuda", "source": source,
                 "replaces": "none: src/repro/models/layers.py:35 rmsnorm is plain jnp",
                 "launches": train["rmsnorm_launches"][i],
                 "launches_per_train_step": train["rmsnorm_per_step"][i],
                 "max_abs_err": r["max_abs_err"] if i == 0 else None,
                 "rms_ratio": None if i == 0 else [r["dx_rms_ratio"], r["dw_rms_ratio"]],
                 "ms": r[key + "_ms"], "plain_ms": r[key + "_plain_ms"],
                 "bound_ms": r[key + "_bound_ms"], "bound_by": "bytes",
                 "library_ms": r[key + "_library_ms"], "shape": r["case"],
                 "cases": {c: {f: x[key + f] for f in ("_ms", "_plain_ms", "_bound_ms",
                                                       "_library_ms")}
                           for c, x in cases.items()},
                 "host_us": train["rmsnorm"]["host"]}
                for i, (name, key) in enumerate((("rmsnorm_fwd (RMSNorm forward)", "fwd"), (
                    "rmsnorm_bwd + rmsnorm_dw (RMSNorm backward)", "bwd")))]

    def later_pf(v):  # phases 11 and 12's replayed K1/K2 launches of one variant
        return [r for ph in (train, mesh)
                for key, r in ph["pred_filter_recs"].items() if key == (v,)]

    later = {"train": train["pred_filter"], "mesh": mesh["pred_filter"]}

    def largest(recs):  # the main path's call with the most K x N
        return max(range(len(recs)), key=lambda i: recs[i]["k"] * recs[i]["n"])

    kdir = "src/repro_torch/kernels"
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(json.dumps({"kernels": [
        entry("pred_filter_batch (comparison variant, K1)", main_recs["cmp"],
              "cmp", main_launches, pick=largest(main_recs["cmp"]),
              also=[*k1, *later_pf("cmp")], later=later),
        entry("pred_filter_batch (set variant, K2)", main_recs["sets"],
              "sets", main_launches, pick=largest(main_recs["sets"]),
              also=[*k2, *later_pf("sets")], later=later),
        entry("pred_filter (single binding, K3)", recs["single"], "single",
              entry_launches),
        entry("membership (K4)", recs["membership"], "membership",
              entry_launches, f"{kdir}/membership/csrc/membership.cu",
              pick=next(i for i, r in enumerate(recs["membership"])
                        if "q3 orders" in r["case"])),
        k5_entry(lm, train, mesh, recs["flash_attention"], entry_launches,
                 f"{kdir}/flash_attn/csrc/flash_attn.cu"),
        k5_backward_entry(lm, train, mesh, recs["flash_attention_backward"],
                          f"{kdir}/flash_attn/csrc/flash_attn_bwd.cu"),
        *rmsnorm_entries(train, f"{kdir}/rmsnorm/csrc/rmsnorm.cu"),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
