"""Multi-pod dry run: trace every (architecture x input shape) cell's step on
the production meshes and record its per-device FLOPs, bytes, collectives
and memory.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out experiments/dryrun]

The reference lowers and compiles each cell with XLA on 512 fake host
devices and reads the compiled HLO.  PyTorch has no HLO, so the port runs
the real step (``build_train`` / ``build_prefill`` / ``build_decode`` of
``launch/steps.py``) on fake tensors, in one process:

* The mesh is ``make_production_mesh(device_type="cpu")`` over a ``fake``
  process group of 256 (or 512) ranks, of which this process is rank 0; a
  collective returns at once and moves nothing.  The group is torn down
  when the cell ends, whatever happens.
* Weights, optimizer state, batch and decode state are ``FakeTensorMode``
  tensors (shapes and dtypes, no storage), placed in their layouts before
  the trace, as ``jax.jit``'s ``in_shardings`` hand them to the reference's
  step.
* :class:`Counter` sees every op the rank runs: DTensor ops come to it as
  the local ops and collectives they become on rank 0's shards, so a
  replicated op costs its whole work on the rank and a sharded one its
  shard's.  FLOPs are ``torch.utils.flop_counter``'s formulas of those
  local ops.  Bytes are each op's input plus output bytes at local shapes:
  eager PyTorch fuses nothing, so that is what the port moves (the HLO's
  ``bytes accessed`` of the reference is a fused graph's).  Collectives are
  the ``torch.distributed`` ops the rank issues, each with its output
  bytes and group size, timed by the reference's ring formulas
  (``roofline.wire_bytes``).  Memory is the fake tensors' peak live bytes
  (each storage counted once while a tensor holds it).
* Attention is K5's work: the kernel is the operator
  ``repro_torch::flash_attention``, which on fake tensors only shapes its
  output and whose FLOP formula is ``4 D`` per unmasked (query, key) pair
  and head; its bytes are q, k, v and o.  A training step's attention
  backward is the plain version's (the port has no backward kernel), and
  is counted op by op as it runs.
* The sequence recurrences (hymba's SSM, xLSTM's mLSTM and sLSTM) run one
  step each, broadcast over time, as XLA's cost analysis counts a scan
  body once; :func:`roofline.ssm_scan_correction` adds the rest, as in the
  reference.  Every layer and microbatch is a real Python loop here, so
  a trace counts each one; with ``analysis`` (the default) a cell is traced
  at ``ANALYSIS_LAYERS`` depths and extrapolated to its own by
  :func:`roofline.combine_delta`, as the reference's analysis lowerings
  are, which keeps a deep model's trace short.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
import weakref
from dataclasses import replace
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import (TorchDispatchMode,
                                         _disable_current_modes)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from ..compat import DTensor
from ..configs import REGISTRY, SHAPES, get
from ..distrib.sharding import axis_rules
from ..models import ssm
from ..models.config import ArchConfig, ShapeConfig
from ..models.model import Model
from ..optim import adamw
from . import roofline as R
from .mesh import make_production_mesh
from .steps import (_opt_sharded, _place_state, build_decode, build_prefill,
                    build_train, decode_state_shardings, param_shardings,
                    shard_model)

# memory ceiling per card (NVIDIA H100 SXM: 80 GB of HBM3)
HBM_PER_CHIP = 80 * 1024**3

# per-arch training overrides: gradient accumulation to bound activation
# memory on the big models (see EXPERIMENTS.md §Dry-run)
TRAIN_OVERRIDES = {
    "mixtral-8x22b": {"accum_steps": 4},
    "granite-34b": {"accum_steps": 4},
    "glm4-9b": {"accum_steps": 2},
    "phi-3-vision-4.2b": {"accum_steps": 2},
    "llama3.2-3b": {"accum_steps": 2},
    "hymba-1.5b": {"accum_steps": 4},
    "seamless-m4t-medium": {"accum_steps": 4},
    "olmoe-1b-7b": {"accum_steps": 4},
    "xlstm-125m": {"accum_steps": 8},
}

# residual-stream sequence sharding (Megatron-SP analogue) for training:
# bounds the remat-saved layer inputs at [L, B, S/model, d]
TRAIN_RULES = {"seq_act": "model"}

# layer counts of the reduced-depth traces (delta method)
ANALYSIS_LAYERS = (2, 4)

_funcol = torch.ops._c10d_functional
_c10d = torch.ops.c10d
# collective op -> the reference's HLO kind
_KINDS = {
    _funcol.all_gather_into_tensor: "all-gather",
    _funcol.all_gather_into_tensor_coalesced: "all-gather",
    _funcol.all_reduce: "all-reduce",
    _funcol.all_reduce_coalesced: "all-reduce",
    _funcol.reduce_scatter_tensor: "reduce-scatter",
    _funcol.reduce_scatter_tensor_coalesced: "reduce-scatter",
    _funcol.all_to_all_single: "all-to-all",
    _c10d.allgather_: "all-gather",
    _c10d._allgather_base_: "all-gather",
    _c10d.allreduce_: "all-reduce",
    _c10d.reduce_scatter_: "reduce-scatter",
    _c10d._reduce_scatter_base_: "reduce-scatter",
    _c10d.alltoall_base_: "all-to-all",
}
# ops that move no data: waiting on a collective, allocating
_NO_TRAFFIC = {_funcol.wait_tensor, torch.ops.aten.empty,
               torch.ops.aten.empty_like, torch.ops.aten.empty_strided}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(func, args) -> int:
    """The ranks of a collective's group, from its arguments."""
    packet = func._overloadpacket
    if packet in (_funcol.all_gather_into_tensor, _funcol.reduce_scatter_tensor,
                  _funcol.all_gather_into_tensor_coalesced,
                  _funcol.reduce_scatter_tensor_coalesced):
        return int(next(a for a in args if isinstance(a, int)))
    if packet._qualified_op_name.startswith("c10d::"):  # (tensors, group, ...)
        return dist.ProcessGroup.unbox(args[1]).size()
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(args[-1]).size()  # funcol: the group name


class Counter(TorchDispatchMode):
    """Counts what one rank runs under it: FLOPs, bytes moved, collectives
    and live bytes of the tensors of ``fake`` (a ``FakeTensorMode``).
    DTensor ops pass through to DTensor (``NotImplemented``), whose local
    ops and collectives come back here.  The ops DTensor's sharding
    propagation runs on global shapes to learn an output's metadata are
    not the rank's work: :func:`dtensor_on_fake` keeps them out."""

    def __init__(self, fake):
        super().__init__()
        self.fake = fake
        self.counts = R.TraceCounts()
        self._live = WeakIdKeyDictionary()
        self._now = 0
        self.quiet = 0  # > 0: DTensor's metadata propagation is running

    # ---- live bytes -------------------------------------------------------- #

    def _release(self, n: int) -> None:
        self._now -= n

    def _hold(self, t: torch.Tensor) -> None:
        if isinstance(t, DTensor):
            t = t._local_tensor
        st = t.untyped_storage()
        if st in self._live:
            return
        n = st.nbytes()
        self._live[st] = n
        weakref.finalize(st, self._release, n)
        self._now += n
        self.counts.peak_bytes = max(self.counts.peak_bytes, self._now)

    def hold(self, *trees) -> None:
        """Count the tensors of ``trees`` (the step's inputs) as live from
        now on: the step's argument bytes."""
        for t in _tensors(trees):
            self._hold(t)
        self.counts.arg_bytes = self._now

    @property
    def live_bytes(self) -> int:
        return self._now

    # ---- the ops ------------------------------------------------------------ #

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.quiet or isinstance(func, torch._ops.HigherOrderOperator):
            return out
        outs = _tensors(out)
        if not any(getattr(t, "fake_mode", None) is self.fake for t in outs):
            return out  # metadata queries, another fake mode's ops
        packet = func._overloadpacket
        c = self.counts
        if packet in _KINDS:
            c.collectives.append(R.collective(
                _KINDS[packet], sum(map(_nbytes, outs)), _group_size(func, args)))
            return out
        if packet in flop_registry:
            c.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view and packet not in _NO_TRAFFIC:
            c.bytes_accessed += sum(map(_nbytes, _tensors((args, kwargs))))
            c.bytes_accessed += sum(map(_nbytes, outs))
        if packet is not _funcol.wait_tensor:
            for t in outs:
                self._hold(t)
        return out


@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``fake`` process group of ``world_size`` ranks, this process rank
    0, destroyed on exit.  Raises when a group is already running."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group; "
                           "this process already has one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _patch(cls, name: str, wrap):
    """Replace the method ``cls.name`` by ``wrap(it)``; returns the undo."""
    raw = vars(cls)[name]
    setattr(cls, name, wrap(raw))
    return lambda: setattr(cls, name, raw)


@contextlib.contextmanager
def dtensor_on_fake(counter: Counter):
    """Two parts of DTensor that assume real tensors, while open: its
    sharding propagation runs ops on fake global-shape tensors to learn an
    output's metadata, which ``counter`` must not count; and a strided
    shard's offsets come from ``arange(...).tolist()``, which a fake tensor
    cannot answer, so they are computed on real tensors."""
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    def quiet(fn):
        def run(*args, **kwargs):
            counter.quiet += 1
            try:
                return fn(*args, **kwargs)
            finally:
                counter.quiet -= 1
        return run

    def real(fn):
        def run(*args, **kwargs):
            with _disable_current_modes():  # the counter's and the fake mode
                return fn(*args, **kwargs)
        return run

    undo = [_patch(ShardingPropagator, n, quiet)
            for n in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
            if n in vars(ShardingPropagator)]
    strided = getattr(placement_types, "_StridedShard", None)
    if strided is not None and "local_shard_size_and_offset" in vars(strided):
        undo.append(_patch(strided, "local_shard_size_and_offset", real))
    try:
        yield
    finally:
        for u in reversed(undo):
            u()


@contextlib.contextmanager
def scan_body_once():
    """Each sequence recurrence of ``models/ssm.py`` runs its first step
    only, the result broadcast over time: the trace counts a scan body once
    and :func:`roofline.ssm_scan_correction` the rest."""
    saved = ssm._mamba_scan, ssm._mlstm_scan, ssm._slstm_scan
    mamba, mlstm, slstm = saved

    def mamba_once(u, decay):
        return mamba(u[:1], decay[:1]).expand_as(u)

    def mlstm_once(state, q, k, v, log_i, log_f):
        y = mlstm(state, q[:, :1], k[:, :1], v[:, :1], log_i[:, :1], log_f[:, :1])
        return y.expand(-1, q.shape[1], *y.shape[2:])

    def slstm_once(p, state, gx, dt_, d):
        h = slstm(p, state, gx[:, :1], dt_, d)
        return h.expand(-1, gx.shape[1], -1)

    ssm._mamba_scan, ssm._mlstm_scan, ssm._slstm_scan = (mamba_once,
                                                         mlstm_once, slstm_once)
    try:
        yield
    finally:
        ssm._mamba_scan, ssm._mlstm_scan, ssm._slstm_scan = saved


def trace_step(mesh, cfg: ArchConfig, shape: ShapeConfig,
               fsdp: bool = True) -> R.TraceCounts:
    """Rank 0's counts for one step of ``shape.kind`` on ``mesh`` (a mesh
    of a fake world): weights from ``Model.init`` in the dtypes ``build_*``
    gives them (float32 for training, bf16 for serving), inputs of the
    shapes it gives, all fake, placed before the step starts."""
    with contextlib.ExitStack() as stack:
        fake = stack.enter_context(FakeTensorMode())
        stack.enter_context(scan_body_once())
        counter = Counter(fake)
        stack.enter_context(dtensor_on_fake(counter))
        if shape.kind == "train":
            step, (p_shapes, _, b_specs) = build_train(mesh, cfg, shape,
                                                       adamw.AdamWConfig(),
                                                       fsdp=fsdp)
        elif shape.kind == "prefill":
            step, (p_shapes, b_specs) = build_prefill(mesh, cfg, shape, fsdp=fsdp)
        else:
            step, (p_shapes, s_shapes, tok) = build_decode(mesh, cfg, shape,
                                                           fsdp=fsdp)
        model = Model.init(cfg, seed=0, device="cpu",
                           dtype=p_shapes["embed"].dtype)
        model = shard_model(model, param_shardings(mesh, cfg, fsdp=fsdp)[2])
        if shape.kind == "decode":
            state = _place_state(
                model.init_decode_state(shape.global_batch, shape.seq_len),
                decode_state_shardings(mesh, cfg, shape, s_shapes))
            tokens = torch.zeros(tok.shape, dtype=tok.dtype)
            counter.hold(dict(model.named_parameters()), state, tokens)
            with counter:
                out = step(model, state, tokens)
        else:
            batch = {k: torch.zeros(s.shape, dtype=s.dtype)
                     for k, s in b_specs.items()}
            args = (model, batch)
            if shape.kind == "train":
                opt = _opt_sharded(adamw.init(dict(model.named_parameters()),
                                              adamw.AdamWConfig()), model)
                args = (model, opt, batch)
            counter.hold(dict(model.named_parameters()), *args[1:])
            with counter:
                out = step(*args)
        counter.counts.end_bytes = counter.live_bytes
        del out
        return counter.counts


def _at_depth(small: R.Roofline, big: R.Roofline, depths, n_layers: int):
    """:func:`roofline.combine_delta` of traces at the two ``depths``, its
    memory extrapolated the same way (weights, optimizer state and the
    activations remat keeps grow by the same amount with each layer)."""
    ls, lb = depths
    rf = R.combine_delta(small, big, ls, lb, n_layers)

    def lin(name: str) -> int:
        a, b = getattr(small, name), getattr(big, name)
        return max(round(a + (n_layers - ls) * (b - a) / (lb - ls)), 0)

    return replace(rf, arg_bytes=lin("arg_bytes"), temp_bytes=lin("temp_bytes"),
                   out_bytes=lin("out_bytes"))


def trace_cell(cfg: ArchConfig, shape: ShapeConfig, world_size: int,
               mesh_fn: Callable, fsdp: bool = True, rules=None,
               depths: Optional[tuple] = None):
    """One cell's rooflines in a fake world of ``world_size`` ranks
    (``mesh_fn()`` builds its mesh): (as traced, with the analytic scan
    correction, seconds).  With ``depths`` (two layer counts) the step is
    traced at those depths and extrapolated to ``cfg.n_layers``, each
    layer's work being the same; otherwise it is traced at full depth."""
    t0 = time.time()
    with fake_world(world_size):
        mesh = mesh_fn()
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        with axis_rules(dict(rules or {})):
            if depths:
                small, big = (R.analyze(trace_step(mesh, replace(cfg, n_layers=n),
                                                   shape, fsdp)) for n in depths)
                traced = _at_depth(small, big, depths, cfg.n_layers)
            else:
                traced = R.analyze(trace_step(mesh, cfg, shape, fsdp))
    batch_shard = sizes.get("pod", 1) * sizes.get("data", 1)
    cf, cb = R.ssm_scan_correction(cfg, shape, batch_shard, sizes.get("model", 1))
    rf = replace(traced, flops=traced.flops + cf,
                 bytes_accessed=traced.bytes_accessed + cb)
    return traced, rf, time.time() - t0


def run_cell(arch: str, shape_name: str, multi_pod: bool, fsdp: bool = True,
             rules=None, verbose: bool = True, analysis: bool = True,
             cfg_overrides=None):
    """Trace one (arch x shape x mesh) cell's step on rank 0 of a fake
    world: its per-device roofline (``roofline``, with the scan correction;
    ``roofline_uncorrected``, as traced), memory and model-FLOP ratio.

    With ``analysis`` (and not xLSTM, whose blocks alternate), the step is
    traced at ``ANALYSIS_LAYERS`` depths and extrapolated to the full
    depth, as the reference's analysis lowerings are; without it, traced
    at full depth (every layer a Python loop here, so both count every
    layer)."""
    cfg = get(arch)
    shape = SHAPES[shape_name]
    ok, why = cfg.supports_shape(shape_name)
    mesh_name = "pod2x16x16" if multi_pod else "16x16"
    cell = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "kind": shape.kind}
    if not ok:
        cell["status"] = "skipped"
        cell["reason"] = why
        return cell

    over = dict(TRAIN_OVERRIDES.get(arch, {})) if shape.kind == "train" else {}
    over.update(cfg_overrides or {})
    cell_rules = dict(TRAIN_RULES) if shape.kind == "train" else {}
    cell_rules.update(rules or {})
    tcfg = replace(cfg, **over)
    ndev = 512 if multi_pod else 256
    rf_full, rf, secs = trace_cell(
        tcfg, shape, ndev,
        lambda: make_production_mesh(multi_pod=multi_pod, device_type="cpu"),
        fsdp, cell_rules,
        ANALYSIS_LAYERS if analysis and not cfg.xlstm else None)
    if verbose:
        print(f"  memory: peak {rf.per_device_hbm_bytes} bytes live on rank 0 "
              f"(arguments {rf.arg_bytes}, outputs {rf.out_bytes})")
        print("  trace: flops=%.3e bytes=%.3e (corrected per-device: "
              "flops=%.3e bytes=%.3e)" % (rf_full.flops, rf_full.bytes_accessed,
                                          rf.flops, rf.bytes_accessed))
    per_dev = rf.per_device_hbm_bytes
    cell.update(
        status="ok",
        devices=ndev,
        compile_s=secs,  # the trace's seconds
        roofline=rf.to_dict(),
        roofline_uncorrected=rf_full.to_dict(),
        per_device_bytes=per_dev,
        per_device_bytes_source="peak live bytes of the fake tensors on rank 0"
        + (f", extrapolated from depths {ANALYSIS_LAYERS}"
           if analysis and not cfg.xlstm else ""),
        fits_hbm=bool(per_dev <= HBM_PER_CHIP),
        model_flops=R.model_flops_per_step(cfg, shape),
        total_params=R.total_params(cfg),
        active_params=R.active_params(cfg),
    )
    # dominant-term summary + MODEL_FLOPS ratio (global = per-device * ndev)
    cell["model_flops_ratio"] = (
        cell["model_flops"] / (rf.flops * ndev) if rf.flops else None
    )
    return cell


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells whose JSON already exists")
    ap.add_argument("--out", type=str, default="experiments/dryrun")
    args = ap.parse_args(argv)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    cells = []
    if args.all:
        for arch in REGISTRY:
            for shape in SHAPES:
                cells.append((arch, shape))
    elif args.arch and args.shape:
        cells.append((args.arch, args.shape))
    else:
        ap.error("--arch/--shape or --all")

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    results = []
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}_{shape}_{'pod2x16x16' if mp else '16x16'}"
            path = outdir / f"{tag}.json"
            if args.resume and path.exists():
                prev = json.loads(path.read_text())
                if prev.get("status") in ("ok", "skipped"):
                    results.append(prev)
                    print(f"=== {tag} (resumed)")
                    continue
            print(f"=== {tag}")
            try:
                # every cell at the analysis depths: here they replace the
                # full-depth trace (the reference skips its analysis
                # lowerings on multi-pod cells, where they are extra compiles)
                cell = run_cell(arch, shape, mp, fsdp=not args.no_fsdp)
            except Exception as e:  # one cell's failure is its record
                traceback.print_exc()
                cell = {
                    "arch": arch, "shape": shape,
                    "mesh": "pod2x16x16" if mp else "16x16",
                    "status": "error", "error": f"{type(e).__name__}: {e}",
                }
            results.append(cell)
            path.write_text(json.dumps(cell, indent=2, default=str))
            if cell.get("status") == "ok":
                rf = cell["roofline"]
                print(
                    f"  ok: dominant={rf['dominant']} compute={rf['compute_s']:.4f}s "
                    f"memory={rf['memory_s']:.4f}s collective={rf['collective_s']:.4f}s "
                    f"per_dev={cell['per_device_bytes']/2**30:.2f}GiB fits={cell['fits_hbm']}"
                )
            else:
                print(f"  {cell['status']}: {cell.get('reason', cell.get('error',''))}")
    (outdir / "summary.json").write_text(json.dumps(results, indent=2, default=str))
    n_ok = sum(1 for c in results if c.get("status") == "ok")
    n_skip = sum(1 for c in results if c.get("status") == "skipped")
    n_err = len(results) - n_ok - n_skip
    print(f"\n{n_ok} ok, {n_skip} skipped (documented), {n_err} errors")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
