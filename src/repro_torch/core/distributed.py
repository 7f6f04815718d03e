"""Partition-granular lineage execution: one scan path for single-node,
multi-core, and device-sharded queries.

:class:`PartitionExecutor` is the fan-out layer above the ScanEngine.  Its
``scan`` method is a drop-in for :meth:`ScanEngine.scan` (same signature,
bit-identical masks) and is what ``PredTrace`` / ``refine`` plug in when
partitioning, a worker pool, or a device mesh is configured:

* **Zone-map pruning** (``scan.prune_zone_maps``) runs first on partitioned
  tables — partitions whose per-column min/max statistics prove no row can
  match are never touched.
* **Surviving partitions** are scanned as slices, either serially or fanned
  out across a thread pool (NumPy releases the GIL in the comparison
  kernels); per-partition masks are merged deterministically by partition
  index, so worker scheduling never changes an answer.  Pool threads run
  only the host backend: a ``TorchBackend`` is not ``parallel_safe``, so
  its kernel launches stay on the calling thread.
* **Device carry**: with the torch backend, a partitioned scan the cost
  model hands to the device is one ``pred_filter_batch`` launch over the
  whole table; the kernel's in-kernel zone check re-prunes every block.
* **Device meshes**: a mesh is a sequence of torch devices (``("cuda:0",)``,
  ``("cuda:0", "cuda:1")``; a device may repeat, and ``("cpu",) * 4`` runs
  four shards through the kernel's plain PyTorch version).  Each table is
  split into ``len(mesh)`` contiguous row ranges; each range is a stable
  slice scanned by a ``TorchBackend`` on its shard's device with its
  cutover at 0 and no cost model, so every shard scan whose atoms the
  kernel takes is a K1/K2 launch there.  Masks are merged by shard index;
  shards run one after another.  There is no padding: the backend sizes
  each launch to its shard, and atoms the kernel cannot take (columns
  beyond int32, floats off the key lane, residual expressions) are
  evaluated on the host inside the backend's own split, as on every other
  path.  The reference package's JAX mesh axes (``mesh_axes``) have no
  counterpart here.
* **Process meshes**: a ``DeviceMesh`` (``launch/mesh.make_host_mesh``)
  spanning the process group splits each table into ``mesh.size()`` row
  ranges the same way; rank r scans range r on its own device (its card
  under NCCL, the CPU under gloo) and one ``all_gather`` per scan joins the
  masks, so every rank holds the same answer.  Every rank runs the same
  refinement, so the collectives line up.

``distributed_refine`` — Algorithm 3 on sharded data — routes the shared
:func:`repro_torch.core.iterative.refine` fixpoint through a
``PartitionExecutor`` scan.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .expr import Expr
from .iterative import IterativePlan, refine
from .lineage import LineageAnswer
from .scan import ScanEngine, TorchBackend, default_engine, resolve_device
from .table import (PartitionedTable, Table, alive_runs, partition_table,
                    table_uid)

# don't spin up threads for scans smaller than this many surviving rows —
# the pool dispatch overhead would dominate
MIN_PARALLEL_ROWS = 16384


def shard_bounds(n: int, shards: int) -> List[Tuple[int, int]]:
    """``shards`` contiguous row ranges covering ``n`` rows, sizes differing
    by at most one (a range may be empty when ``n < shards``)."""
    edges = [n * i // shards for i in range(shards + 1)]
    return list(zip(edges[:-1], edges[1:]))


class _DeviceTable:
    """One table's rows split over the mesh: a stable row-range slice per
    shard, each scanned by the backend of its shard's device.  The slices
    live as long as this object, so the backends' slab caches (keyed by
    table identity) upload each shard's columns once, however many
    refinement iterations scan it."""

    def __init__(self, table: Table, backends: Sequence[TorchBackend]):
        self.nrows = table.nrows
        self.shards = [
            (lo, hi, be, Table({k: v[lo:hi] for k, v in table.cols.items()},
                               table.dicts, table.name))
            for (lo, hi), be in zip(shard_bounds(table.nrows, len(backends)),
                                    backends)]

    def scan(self, prog, binding: Dict[str, object]) -> np.ndarray:
        """Each shard's mask from its device's backend, merged by shard
        index.  A launch error on any shard reaches the caller."""
        mask = np.zeros(self.nrows, dtype=bool)
        for lo, hi, be, sub in self.shards:
            if hi > lo:
                mask[lo:hi] = be.scan(prog, sub, binding)
        return mask


class _RankTable:
    """One table's rows split over a process mesh: this rank's stable
    row-range slice, scanned by its own backend; the masks of all ranks
    joined by an ``all_gather`` (each padded to the longest range)."""

    def __init__(self, table: Table, backend: TorchBackend, rank: int,
                 world: int, comm_device: torch.device):
        self.nrows = table.nrows
        self.bounds = shard_bounds(table.nrows, world)
        lo, hi = self.bounds[rank]
        self.backend, self.comm_device = backend, comm_device
        self.sub = Table({k: v[lo:hi] for k, v in table.cols.items()},
                         table.dicts, table.name)

    def scan(self, prog, binding: Dict[str, object]) -> np.ndarray:
        width = max(hi - lo for lo, hi in self.bounds)
        local = torch.zeros(width, dtype=torch.uint8, device=self.comm_device)
        if self.sub.nrows:
            mask = self.backend.scan(prog, self.sub, binding)
            local[:self.sub.nrows] = torch.from_numpy(
                mask.view(np.uint8)).to(self.comm_device)
        out = torch.empty(width * len(self.bounds), dtype=torch.uint8,
                          device=self.comm_device)
        dist.all_gather_into_tensor(out, local)
        parts = out.view(len(self.bounds), width).cpu().numpy().view(bool)
        return np.concatenate([parts[r, :hi - lo]
                               for r, (lo, hi) in enumerate(self.bounds)])


class PartitionExecutor:
    """Fans predicate scans out over table partitions (and devices).

    One executor serves one PredTrace / refine loop; it shares the owning
    ScanEngine, so compiled atom programs and partition-slice views are
    reused across every scan it dispatches."""

    def __init__(self, engine: Optional[ScanEngine] = None,
                 max_workers: Optional[int] = None,
                 mesh: Optional[Sequence] = None,
                 min_parallel_rows: Optional[int] = None):
        self.engine = engine or default_engine()
        self.max_workers = max_workers
        # None -> measured lazily on first fan-out decision (pool round-trip
        # overhead vs. per-row scan cost on *this* host — core/dispatch.py);
        # an explicit int is honored verbatim (tests pin 0 to force fan-out)
        self._min_parallel_rows = min_parallel_rows
        self._pool: Optional[ThreadPoolExecutor] = None
        self.mesh = None
        self._shard_backends: List[TorchBackend] = []
        self._rank_backend: Optional[TorchBackend] = None
        if mesh is not None and hasattr(mesh, "mesh_dim_names"):  # DeviceMesh
            if mesh.size() != dist.get_world_size():
                raise ValueError(f"a process mesh must span the process group: "
                                 f"{mesh.size()} of {dist.get_world_size()} "
                                 f"ranks")
            self.mesh = mesh
            dev = (torch.device("cuda", torch.cuda.current_device())
                   if mesh.device_type == "cuda" else torch.device("cpu"))
            self._rank_backend = TorchBackend(device=dev, device_cutover=0)
            self._rank_backend.attach_stats(self.engine.stats)
        elif mesh is not None:
            # resolved now: a mesh naming a card on a host without one
            # raises here, before any scan
            self.mesh = tuple(resolve_device(d) for d in mesh)
            if not self.mesh:
                raise ValueError("a mesh needs at least one device")
            # a mesh is an explicit placement: every in-fragment shard scan
            # launches on its device (cutover 0, no cost model to learn a
            # host slope from small shards and send their scans back to
            # the host); launches still count in the engine's stats
            per_dev: Dict[object, TorchBackend] = {}
            for d in self.mesh:
                be = per_dev.get(d)
                if be is None:
                    be = per_dev[d] = TorchBackend(device=d, device_cutover=0)
                    be.attach_stats(self.engine.stats)
                self._shard_backends.append(be)
        # table uid -> (weakref, _DeviceTable); weakref eviction keeps dead
        # tables from pinning device memory
        self._device: Dict[int, Tuple[weakref.ref, _DeviceTable]] = {}
        # reentrancy: scan() may be called from many service/request threads
        # at once; the lock guards lazy pool creation and the device-table
        # install so racing callers never leak a second pool or overwrite
        # each other's device tables
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ #
    @property
    def min_parallel_rows(self) -> int:
        """Surviving-row threshold below which fan-out is not worth the pool
        round-trip.  Measured once per executor unless set explicitly."""
        v = self._min_parallel_rows
        if v is None:
            pool = self.pool()
            if pool is None:
                v = MIN_PARALLEL_ROWS
            else:
                from .dispatch import parallel_scan_cutover

                v = parallel_scan_cutover(pool, pool._max_workers)
            self._min_parallel_rows = v
        return v

    @min_parallel_rows.setter
    def min_parallel_rows(self, v: Optional[int]) -> None:
        self._min_parallel_rows = v

    def pool(self) -> Optional[ThreadPoolExecutor]:
        if self.max_workers == 0:
            return None
        if self._pool is None:
            workers = self.max_workers or min(os.cpu_count() or 1, 16)
            if workers <= 1:
                return None
            with self._lock:
                if self._pool is None:
                    self._pool = ThreadPoolExecutor(
                        max_workers=workers,
                        thread_name_prefix="predtrace-part",
                    )
        return self._pool

    def close(self) -> None:
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            if self._pool is not None:
                self._pool.shutdown(wait=False)
        except Exception:
            pass

    # ------------------------------------------------------------------ #
    def scan(self, pred: Expr, table: Table,
             binding: Optional[Dict[str, object]] = None) -> np.ndarray:
        """Boolean mask of ``pred`` over ``table`` — drop-in for
        ``ScanEngine.scan`` with partition pruning, worker fan-out, the
        device carry and the mesh layered on top.  Answers are identical by
        construction: pruning only skips partitions proved empty, and
        per-partition and per-shard masks are merged by index."""
        binding = binding or {}
        self.engine.stats.bump(scans=1)
        if self.mesh is not None:
            return self._device_scan(pred, table, binding)
        plan = self.engine.partition_plan(pred, table, binding)
        if plan is None:
            return self.engine.backend.scan(
                self.engine.compile(pred), table, binding
            )
        return self._fanout_scan(pred, table, binding, plan)

    # ------------------------------------------------------------------ #
    def parallel_ratio(self) -> float:
        """Seeded marginal cost of the fan-out route relative to a serial
        scan: ``1/W`` of the work per wall-second with W pool workers,
        floored at 0.5 (matching the dispatch probe's savable fraction)."""
        pool = self.pool()
        workers = pool._max_workers if pool is not None else 1
        return min(1.0 / max(workers, 2), 0.5)

    def _parallel_seed(self) -> Dict[str, float]:
        from .cost import PARALLEL_CAL_ATOMS

        return {"cutover": float(self.min_parallel_rows) * PARALLEL_CAL_ATOMS,
                "ratio": self.parallel_ratio()}

    def _fanout_scan(self, pred: Expr, table: PartitionedTable,
                     binding: Dict[str, object], plan) -> np.ndarray:
        from .cost import active_recorder, prog_atoms

        prog, alive = plan
        n = table.nrows
        backend = self.engine.backend
        cm = self.engine.cost_model
        A = prog_atoms(prog)
        carry = getattr(backend, "fused_carry_ok", None)
        if carry is None:
            # serial shortcut before any run/bounds bookkeeping: even if
            # every surviving partition were full, the fan-out estimate must
            # lose to the serial one before any pool round-trip is worth it
            cap = float(np.count_nonzero(alive) * table.part_rows) * A
            if (self.max_workers == 0
                    or cm.estimate("parallel", cap, **self._parallel_seed())
                    >= cm.estimate("serial", cap)):
                return self.engine._scan_pruned(prog, table, binding, plan)
        runs = alive_runs(alive)
        if not runs:
            self.engine.record_prune(0, len(alive))
            return np.zeros(n, dtype=bool)
        pr = table.part_rows
        bounds = [(p0 * pr, min(p1 * pr, n)) for p0, p1 in runs]
        pool = self.pool() if getattr(backend, "parallel_safe", False) else None
        total = sum(hi - lo for lo, hi in bounds)
        # device carrier: when the backend's fused kernel can take the whole
        # scan, launch it over the full table — the kernel's in-kernel zone
        # check re-prunes every block (a superset of the partition pruning
        # already computed), so surviving partitions are never sliced.  The
        # carry verdict is the backend's cost-model compare (fused_carry_ok).
        carried = carry is not None and carry(prog, table, binding, total)
        refused = None
        if carry is not None and not carried:
            # the device carry was considered and refused by the backend's
            # own cost compare — surface that exactly like the store's
            # ranked-walk fallback: the decision's ``fallback_from`` names
            # the refused route once ``done(route=...)`` reports what ran
            self.engine.stats.bump(carry_refused=1)
            if active_recorder() is not None:
                refused = cm.note(
                    f"scan:{getattr(table, 'name', None) or '?'}",
                    "device", float(total) * A,
                    meta={"rows": int(n), "atoms": int(A),
                          "rows_alive": int(total), "carry": False},
                    alternatives=[("serial", float(n) * A),
                                  ("pruned", float(total + pr) * A),
                                  ("parallel", float(total) * A,
                                   self._parallel_seed())])
        if carried:
            ns = int(np.count_nonzero(alive))
            self.engine.record_prune(ns, len(alive) - ns)
            ch = cm.note(f"scan:{getattr(table, 'name', None) or '?'}",
                         "device", float(total) * A,
                         meta={"rows": int(n), "atoms": int(A),
                               "rows_alive": int(total), "carry": True})
            t0 = time.perf_counter()
            mask = backend.scan(prog, table, binding)
            ch.done(time.perf_counter() - t0)
            return mask
        if (pool is None or len(bounds) <= 1
                or cm.estimate("parallel", float(total) * A,
                               **self._parallel_seed())
                >= min(cm.estimate("serial", float(n) * A),
                       cm.estimate("pruned", float(total + pr) * A))):
            # small / contiguous work: the engine's serial pruned scan picks
            # the cheapest shape (slice, gather, or full scan)
            t0 = time.perf_counter()
            mask = self.engine._scan_pruned(prog, table, binding, plan)
            if refused is not None:
                # visibility-only: _scan_pruned records and observes its own
                # decision for the same wall time
                refused.done(time.perf_counter() - t0, route="pruned",
                             work=float(total + pr) * A, observe=False)
            return mask
        ns = int(np.count_nonzero(alive))
        self.engine.record_prune(ns, len(alive) - ns)
        if refused is not None:
            ch = refused
        else:
            ch = cm.note(f"scan:{getattr(table, 'name', None) or '?'}",
                         "parallel", float(total) * A, meta={
                             "rows": int(n), "atoms": int(A),
                             "rows_alive": int(total), "alive": ns},
                         alternatives=[("serial", float(n) * A),
                                       ("pruned", float(total + pr) * A)])
        t0 = time.perf_counter()
        mask = self.fanout_bounds(prog, table, binding, bounds, pool)
        ch.done(time.perf_counter() - t0,
                route="parallel" if refused is not None else None,
                work=float(total) * A if refused is not None else None)
        return mask

    def fanout_bounds(self, prog, table: Table, binding: Dict[str, object],
                      bounds, pool) -> np.ndarray:
        """Pool fan-out over surviving partition runs; also the hand-off
        target of ``ScanEngine._scan_pruned`` when an engine carries this
        executor as its ``fanout`` hook."""
        backend = self.engine.backend
        self.engine.stats.bump(fanout_scans=1)
        mask = np.zeros(table.nrows, dtype=bool)
        # slices are created (and cached) serially; workers only evaluate
        subs = [self.engine.partition_slice(table, lo, hi) for lo, hi in bounds]
        results = pool.map(lambda sub: backend.scan(prog, sub, binding), subs)
        for (lo, hi), m in zip(bounds, results):
            mask[lo:hi] = m
        return mask

    # ------------------------------------------------------------------ #
    def _device_scan(self, pred: Expr, table: Table,
                     binding: Dict[str, object]) -> np.ndarray:
        # zone maps still short-circuit provably-empty scans before any
        # device work; partial pruning stays in the kernel's zone check
        plan = self.engine.partition_plan(pred, table, binding)
        if plan is not None:
            if not plan[1].any():
                self.engine.record_prune(0, len(plan[1]))
                return np.zeros(table.nrows, dtype=bool)
            self.engine.record_prune(len(plan[1]), 0)
        prog = plan[0] if plan is not None else self.engine.compile(pred)
        return self._device_table(table).scan(prog, binding)

    def _device_table(self, table: Table):
        tk = table_uid(table)
        entry = self._device.get(tk)
        if entry is not None and entry[0]() is table \
                and entry[1].nrows == table.nrows:
            return entry[1]
        with self._lock:
            entry = self._device.get(tk)
            if entry is not None and entry[0]() is table \
                    and entry[1].nrows == table.nrows:
                return entry[1]
            if self._rank_backend is not None:
                be = self._rank_backend
                dt = _RankTable(table, be, dist.get_rank(),
                                dist.get_world_size(), be.device)
            else:
                dt = _DeviceTable(table, self._shard_backends)
            ref = weakref.ref(table,
                              lambda _, k=tk, d=self._device: d.pop(k, None))
            self._device[tk] = (ref, dt)
        return dt


def distributed_refine(
    ip: IterativePlan,
    catalog: Dict[str, Table],
    binding: Dict[str, object],
    mesh: Optional[Sequence] = None,
    max_iters: int = 32,
    engine: Optional[ScanEngine] = None,
    num_partitions: Optional[int] = None,
    max_workers: Optional[int] = None,
) -> LineageAnswer:
    """Algorithm 3 phase 4 with partition/device-sharded scans.

    The fixpoint itself is the shared :func:`repro_torch.core.iterative.refine`
    loop; only the scan differs — a :class:`PartitionExecutor` that routes
    every predicate through the shared ScanEngine, or, with a ``mesh`` (a
    sequence of torch devices, or a ``DeviceMesh`` of processes), through
    each shard's kernel launch."""
    t0 = time.perf_counter()
    cat = catalog
    if num_partitions is not None:
        cat = {k: partition_table(t, num_partitions=num_partitions)
               for k, t in catalog.items()}
    pexec = PartitionExecutor(engine or default_engine(), mesh=mesh,
                              max_workers=max_workers)
    try:
        rr = refine(ip, cat, binding, max_iters, scan=pexec.scan)
    finally:
        pexec.close()
    ans = LineageAnswer(dict(rr.lineage), time.perf_counter() - t0)
    ans.detail["iterations"] = rr.iterations
    return ans
