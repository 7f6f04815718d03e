"""PredTrace facade: the three-phase workflow of paper Algorithm 1.

* ``infer()``      — logical lineage inference (once per pipeline, data-free
                     apart from optional size stats for Algorithm 2).
* ``run()``        — pipeline execution phase: executes the (possibly
                     modified) pipeline, saving column-projected intermediate
                     results where the plan requires them.
* ``query(...)``   — lineage querying phase: concretize the pushed-down
                     predicates from a target output row and run them on the
                     intermediates + source tables.
* ``query_iterative(...)`` — Algorithm 3 (no intermediate results).

Scans run on the device given to :class:`PredTrace` (the CUDA card unless
the caller asks for the CPU) through the ``TorchBackend`` of
``core/scan.py``; a worker pool or a mesh of torch devices runs them
through ``core/distributed.py``'s ``PartitionExecutor``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from . import ops as O
from .executor import ExecResult, Executor
from .expr import (
    BinOp, Col, Expr, FALSE, IsIn, Param, cols_of, conjuncts, eval_np,
    params_of,
)
from .iterative import IterativeInference, IterativePlan, RefineResult, refine
from .plan import (
    LineageInference, LineagePlan, MaterializationPlan, SourcePred, Stage,
    plan_materialization,
)
from .scan import ScanEngine, prune_zone_maps
from .store import IntermediateStore, StoredTable
from .table import (
    PartitionedTable, Table, delta_view, encode_delta_like, partition_table,
    table_uid,
)


def _eq_only_params(pred: Expr) -> set:
    """Params that appear exclusively as ``col == $p`` / ``$p == col`` /
    ``col IN $p`` atoms — for these, array bindings have exact
    set-membership semantics per atom."""
    eq, non_eq = set(), set()
    for a in conjuncts(pred):
        a_params = params_of(a)
        if isinstance(a, BinOp) and a.op == "==" and (
            isinstance(a.left, Param) or isinstance(a.right, Param)
        ) and len(a_params) == 1:
            eq |= a_params
        elif isinstance(a, IsIn) and isinstance(a.values, Param):
            eq |= a_params
        else:
            non_eq |= a_params
    return eq - non_eq


def _binding_groups(pred: Expr, binding: Dict[str, object],
                    param_stage: Dict[str, int],
                    analysis: Optional[Tuple[set, set]] = None):
    """Classify array-bound stage params: ``tuple_groups`` need zip (tuple)
    membership semantics, ``rowwise`` need per-stage-row binding.  Both empty
    means the predicate is a plain conjunction scan the ScanEngine handles.
    ``analysis`` is the binding-independent ``(params_of, eq_only_params)``
    pair — pass it when classifying many bindings of one predicate."""
    used, eq_ok = analysis if analysis is not None else (
        params_of(pred), _eq_only_params(pred)
    )
    by_stage: Dict[int, List[str]] = {}
    for p in used:
        v = binding.get(p)
        if not isinstance(v, np.ndarray):
            continue
        sid = param_stage.get(p)
        if sid is None:
            continue
        by_stage.setdefault(sid, []).append(p)
    tuple_groups: Dict[int, List[str]] = {}
    rowwise: Dict[int, List[str]] = {}
    for sid, plist in by_stage.items():
        if any(p not in eq_ok for p in plist):
            rowwise[sid] = plist  # non-equality use: bind per stage row
        elif len(plist) >= 2:
            tuple_groups[sid] = plist  # multi-column: zip (tuple) semantics
    return tuple_groups, rowwise


def _zone_restrict(table: Table, atoms) -> np.ndarray:
    """Candidate row indices for the tuple-membership evaluator: on a
    partitioned table, partitions whose zone-map range cannot intersect the
    leading atom's value set are dropped before the full-column ``isin`` —
    the same conservative pruning the ScanEngine applies to plain scans."""
    from .scan import _set_overlap
    from .table import PartitionedTable, rows_of_alive

    n = table.nrows
    if isinstance(table, PartitionedTable) and table.num_partitions > 1 and atoms:
        lhs0, sel0 = atoms[0]
        zm = table.zone_maps
        if isinstance(lhs0, Col) and lhs0.name in zm.lo:
            vals = np.asarray(sel0)
            if vals.ndim == 1 and vals.dtype.kind in "iufb":
                alive = _set_overlap(vals, zm.lo[lhs0.name], zm.hi[lhs0.name])
                if not alive.all():
                    return rows_of_alive(alive, zm.part_rows, n)
    return np.arange(n)


def _eval_pred(pred: Expr, table: Table, binding: Dict[str, object],
               param_stage: Dict[str, int], stage_sel: Dict[int, Table],
               param_col: Dict[str, str],
               scan=None, analysis=None) -> np.ndarray:
    """Evaluate a concretized predicate.

    Array-bound params appearing only in equality atoms keep set semantics
    (exact per atom).  Params from the *same* materialized stage that appear
    in non-equality atoms, or co-occur (cross-product hazard), are bound
    PER STAGE ROW and the masks OR'd — the paper's "replace variables with
    the corresponding rows".  ``scan`` is the compiled-scan backend for the
    plain-conjunction fragments (defaults to the tree evaluator);
    ``analysis`` the binding-independent pair :func:`_binding_groups`
    accepts, for callers that evaluate one predicate many times."""
    if scan is None:
        scan = lambda p, t, b: np.asarray(eval_np(p, t.cols, b, n=t.nrows), bool)
    tuple_groups, rowwise = _binding_groups(pred, binding, param_stage,
                                            analysis=analysis)
    if not rowwise and not tuple_groups:
        return scan(pred, table, binding)

    mask = np.ones(table.nrows, dtype=bool)
    consumed_atoms = []

    # composite-tuple membership: exact — independent per-atom value sets
    # would be a cross-product superset.  Evaluation narrows progressively
    # (first atoms are usually keys), then verifies tuple consistency on the
    # few surviving candidates.
    from .expr import cols_of as _cols_of
    from .scan import _sorted_unique

    for sid, plist in tuple_groups.items():
        from .executor import composite_codes

        sel = stage_sel[sid]
        atoms = []
        for a in conjuncts(pred):
            ap = params_of(a)
            if len(ap) == 1 and next(iter(ap)) in plist and isinstance(a, BinOp):
                p = next(iter(ap))
                lhs = a.left if isinstance(a.right, Param) else a.right
                atoms.append((lhs, np.asarray(sel.cols[param_col[p]])))
                consumed_atoms.append(a)
        idx = _zone_restrict(table, atoms)
        lhs_vals = []
        for lhs, sel_vals in atoms:
            env = {c: table.cols[c][idx] for c in _cols_of(lhs)}
            v = np.asarray(eval_np(lhs, env, {}, n=len(idx)))
            # sorted-unique is hoisted out of the per-partition loop: the
            # stage selection array is the same object every call, so the
            # id-keyed cache sorts it once per predicate, not once per part
            keep = np.isin(v, _sorted_unique(sel_vals))
            idx = idx[keep]
            lhs_vals = [lv[keep] for lv in lhs_vals]
            lhs_vals.append(v[keep])
        if len(atoms) > 1 and len(idx):
            ct, cs = composite_codes(lhs_vals, [sv for _, sv in atoms])
            idx = idx[np.isin(ct, cs)]
        gmask = np.zeros(table.nrows, dtype=bool)
        gmask[idx] = True
        mask &= gmask

    rest = [a for a in conjuncts(pred) if a not in consumed_atoms]
    rest_params = set()
    for a in rest:
        rest_params |= params_of(a)
    rowwise_params = [p for plist in rowwise.values() for p in plist]
    if not (rest_params & set(rowwise_params)):
        if rest:
            from .expr import land

            mask &= scan(land(*rest), table, binding)
        return mask

    # non-equality params (window ranges etc.): bind per stage row and OR
    assert len(rowwise) == 1, (
        "row-wise binding across multiple stages is not supported; "
        "plan inference should not produce this shape"
    )
    (sid, plist), = rowwise.items()
    sel = stage_sel[sid]
    cols = [param_col[p] for p in plist]
    rows = np.unique(np.stack([np.asarray(sel.cols[c]) for c in cols], axis=1), axis=0)
    rmask = np.zeros(table.nrows, dtype=bool)
    from .expr import land

    rest_pred = land(*rest)
    for r in rows:
        b2 = dict(binding)
        for p, val in zip(plist, r):
            b2[p] = val.item() if hasattr(val, "item") else val
        rmask |= scan(rest_pred, table, b2)
    return mask & rmask


@dataclass
class LineageAnswer:
    lineage: Dict[str, np.ndarray]  # table -> source row ids
    seconds: float = 0.0
    detail: Dict[str, object] = field(default_factory=dict)
    # per-table precision flag: True = certified exact lineage (Lemma 3.1
    # with every needed intermediate materialized), False = sound superset
    # (iterative fallback, or an unmaterialized opaque-UDF boundary above
    # the table).  Tables absent from the dict default to precise.
    precise: Dict[str, bool] = field(default_factory=dict)
    # full plan/cost breakdown (a repro_torch.core.cost.PlanReport) — populated by
    # PredTrace.explain(); plain query() leaves it None (recording off)
    plan: Optional[object] = field(default=None, repr=False)
    # query-time context for the warm delta-extension path
    # (:meth:`PredTrace.query_delta`): ``(binding, param_stage, param_col,
    # stage_sel)`` where ``stage_sel`` is the selection dict or a zero-arg
    # thunk building it lazily (batch path).  Only precise, fully
    # materialized answers carry one.
    delta_ctx: Optional[tuple] = field(default=None, repr=False, compare=False)

    def total_rows(self) -> int:
        return int(sum(len(v) for v in self.lineage.values()))

    def all_precise(self) -> bool:
        """Is every table's lineage certified exact (no superset fallback)?"""
        return all(self.precise.get(t, True) for t in self.lineage)


def delta_compatible(old, new) -> bool:
    """Can an answer stamped with generation token ``old`` be *extended* to
    token ``new`` by a delta rescan (:meth:`PredTrace.query_delta`)?

    Tokens are ``(base, marks)`` pairs from
    :meth:`PredTrace.answer_generation`.  Compatible means: the same base
    (no full re-run or store invalidation in between), the same set of
    tables and materialized stages, and every row watermark moved forward
    or stayed — i.e. the only difference is appended rows.  Equal tokens
    are trivially compatible."""
    try:
        (ob, om), (nb, nm) = old, new
    except (TypeError, ValueError):
        return False
    if ob != nb:
        return False
    od = {m[:2]: m[2] for m in om}
    nd = {m[:2]: m[2] for m in nm}
    if set(od) != set(nd):
        return False
    return all(od[k] <= nd[k] for k in od)


def _is_null(v) -> bool:
    try:
        return (isinstance(v, float) and np.isnan(v)) or int(v) == -1
    except (TypeError, ValueError):
        return False


def _uniq(v: np.ndarray) -> np.ndarray:
    """``np.unique`` with fast paths for the overwhelmingly common shapes of
    stage-binding columns: empty/singleton, and constant (the selected stage
    rows share the group key)."""
    if len(v) <= 1:
        return v
    if (v[0] == v).all():
        return v[:1]
    return np.unique(v)


def _clean_binding_value(v):
    """Normalize a bound value: drop null sentinels from arrays, collapse
    singleton arrays to scalars."""
    if isinstance(v, np.ndarray):
        if v.dtype.kind == "f":
            v = v[~np.isnan(v)]
        elif v.dtype.kind in "iu":
            v = v[v != -1]
        if len(v) == 1:
            return v[0].item()
        return v
    return v


class PredTrace:
    """The paper's end-to-end system: row-level lineage for a pipeline via
    predicate pushdown.

    Three-phase workflow::

        pt = PredTrace(catalog, plan, store=True, num_partitions=64)
        pt.infer(stats=...)   # 1. lineage inference (pushdown, Algorithm 1)
        pt.run()              # 2. pipeline execution (+ stage materialization)
        ans = pt.query(row)   # 3. lineage queries (Lemma 3.1 / Algorithm 3)

    ``query`` returns a :class:`LineageAnswer` mapping each source table to
    the row ids the selected output row(s) derive from; ``explain`` runs the
    same query with plan recording on and returns the cost-model
    :class:`~repro_torch.core.cost.PlanReport`.  Optional knobs: a compressed
    :class:`IntermediateStore` with a byte budget (per-table degradation to
    the iterative/superset path), a disk tier for stages that miss it,
    fixed-size partitioning with zone-map pruning, a worker pool, or a mesh
    of torch devices — answers are identical under every configuration."""

    def __init__(
        self,
        catalog: Dict[str, Table],
        plan: O.Node,
        optimize_placement: bool = True,
        precise_minmax: bool = False,
        scan_engine: Optional[ScanEngine] = None,
        store: Union[bool, IntermediateStore, None] = None,
        budget_bytes: Optional[int] = None,
        disk_budget_bytes: Optional[int] = 0,
        num_partitions: Optional[int] = None,
        partition_rows: Optional[int] = None,
        parallel: Union[bool, int, None] = None,
        mesh=None,
        device=None,
    ):
        """Build a lineage system for one pipeline.

        Args:
            catalog: source tables by name.
            plan: pipeline plan (``repro_torch.core.ops`` operator tree).
            optimize_placement: run the Algorithm-2 placement optimizer
                when execution stats are supplied to :meth:`infer`.
            precise_minmax: push min/max aggregate predicates precisely
                instead of falling back to the superset bound.
            scan_engine: shared :class:`ScanEngine` (one on the torch
                backend is created when omitted; its cost model drives every
                dispatch decision).  ``ScanEngine("numpy")`` is the host
                oracle.
            store: ``True`` to materialize stages into a fresh compressed
                :class:`IntermediateStore`, or an existing store instance.
            budget_bytes: store byte budget (``None`` = keep everything,
                ``0`` = keep nothing — pure iterative path).
            disk_budget_bytes: second-tier byte budget for the out-of-core
                store: stages that miss the RAM budget are *demoted* to
                memmap-backed disk payloads (still scanned in situ, still
                precise) instead of dropped, while they fit this budget
                (``None`` = unlimited disk, ``0`` = tier disabled).
            num_partitions / partition_rows: fixed-size partition layout
                with zone maps; lineage scans prune partitions first.
            parallel: fan surviving partitions over a thread pool
                (``True`` = default size, int = worker count); scans the
                device carries stay one kernel launch on the caller's thread.
            mesh: sequence of torch devices (e.g. ``("cuda:0",)``; a device
                may repeat) to shard every lineage scan over, one
                ``TorchBackend`` launch per shard (``core/distributed.py``).
            device: torch device of the scans when ``scan_engine`` is
                omitted — ``None`` is the CUDA card (raises without one),
                ``"cpu"`` runs the kernel's plain PyTorch version.
        """
        # partitioned table runtime: with ``num_partitions``/``partition_rows``
        # every source table (and every materialized stage) is split into
        # fixed-size row chunks carrying zone maps; lineage-query scans prune
        # whole chunks before any row-level work.  ``parallel`` fans the
        # surviving chunks out across a worker pool; ``mesh`` runs them
        # sharded over torch devices.  Answers are identical
        # with partitioning on or off.
        self.num_partitions = num_partitions
        self.partition_rows = partition_rows
        if num_partitions is not None or partition_rows is not None:
            catalog = {
                k: partition_table(t, num_partitions, partition_rows)
                for k, t in catalog.items()
            }
        self.catalog = catalog
        self.plan = plan
        self.optimize_placement = optimize_placement
        self.precise_minmax = precise_minmax
        # one engine per PredTrace: compiled atom programs are shared across
        # plan execution (Filter scans) and every lineage query of this plan
        self.scan_engine = scan_engine or ScanEngine("torch", device=device)
        self.executor = Executor(catalog, scan_engine=self.scan_engine)
        # compressed intermediate store + byte budget: store=True (or any
        # budget_bytes) materializes stages encoded (core/store.py); the
        # budget planner then drops stages that don't fit and their dependent
        # source predicates degrade to the iterative/superset path
        self._owns_store = store is True or (
            store is None and budget_bytes is not None)
        if self._owns_store:
            store = IntermediateStore(budget_bytes,
                                      num_partitions=num_partitions,
                                      part_rows=partition_rows)
        self.store: Optional[IntermediateStore] = (
            store if isinstance(store, IntermediateStore) else None
        )
        self.budget_bytes = budget_bytes
        self.disk_budget_bytes = disk_budget_bytes
        # one scan entry point for every query path: the engine directly, or
        # a PartitionExecutor fanning surviving partitions over workers/mesh
        self.partition_exec = None
        if parallel or mesh is not None:
            from .distributed import PartitionExecutor

            # `parallel is True` (not ==): parallel=1 means one worker, and
            # 1 == True would otherwise select the default-sized pool
            workers = (None if parallel is True or parallel is None
                       else int(parallel))
            self.partition_exec = PartitionExecutor(
                self.scan_engine, max_workers=workers, mesh=mesh
            )
            if (mesh is not None or getattr(self.scan_engine.backend,
                                            "fused_carry_ok", None) is not None):
                # mesh sharding / device-carry backends need the executor's
                # own dispatch on every scan
                self._scan = self.partition_exec.scan
            else:
                # worker fan-out only: scans stay on the engine's serial path
                # and hand off to the executor *inside* _scan_pruned, only
                # when surviving work clears the measured cutover — below it
                # the parallel configuration is cost-identical to serial
                self.scan_engine.fanout = self.partition_exec
                self._scan = self.scan_engine.scan
        else:
            self._scan = self.scan_engine.scan
        self.mat_plan: Optional[MaterializationPlan] = None
        self.lineage_plan: Optional[LineagePlan] = None
        self.iter_plan: Optional[IterativePlan] = None
        self.exec_result: Optional[ExecResult] = None
        self.infer_seconds: float = 0.0
        # guards lazy iterative-plan inference: concurrent query() calls that
        # hit the superset fallback would otherwise race infer_iterative()
        self._lazy_lock = threading.RLock()

    # ------------------------------------------------------------------ #
    def close(self) -> None:
        """Release the parallel partition executor's worker pool and — when
        this PredTrace created its own store — the store's out-of-core spill
        root (no-ops otherwise).  Long-lived services that build many
        PredTraces should call this, or use the instance as a context
        manager."""
        if self.partition_exec is not None:
            self.partition_exec.close()
        if self._owns_store and self.store is not None:
            self.store.close()

    def __enter__(self) -> "PredTrace":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ #
    def answer_generation(self) -> Tuple[Tuple[int, int], Tuple]:
        """Version token of the data any lineage answer derives from:
        ``(base, marks)``.

        ``base`` is ``(run_generation, store_generation)`` — both from
        process-wide monotone sequences, bumped by every full ``run()`` /
        ``run_unmodified()`` and every store ``put``/``evict``, so a base
        pair never repeats.  ``marks`` is a sorted tuple of per-object row
        watermarks: ``("t", table_name, nrows)`` for every catalog source
        table and ``("s", node_id, nrows)`` for every materialized stage.
        A pure append-only :meth:`run_delta` leaves ``base`` untouched and
        only moves watermarks forward — the LineageService keeps answers
        stamped with an older-watermark token warm and extends them via
        :meth:`query_delta` (see :func:`delta_compatible`); any ``base``
        mismatch is a hard invalidation."""
        store_gen = self.store.generation if self.store is not None else 0
        marks = [("t", name, int(t.nrows))
                 for name, t in self.catalog.items()]
        if self.exec_result is not None:
            for nid, obj in self.exec_result.materialized.items():
                marks.append(("s", int(nid), int(obj.nrows)))
        return ((self.executor.run_generation, store_gen),
                tuple(sorted(marks)))

    def precision_token(self) -> Tuple:
        """The effective budget/precision mode answers are produced under:
        the active byte budget plus the set of budget-dropped stages.  Two
        answers computed under different tokens are different *kinds* of
        answer (precise vs per-table superset) even when the underlying data
        generations coincide — the LineageService keys its answer cache on
        this so a superset answer cached under a tight budget is never served
        to a caller who restored precision (or vice versa)."""
        if self.mat_plan is not None:
            return (self.mat_plan.budget_bytes,
                    tuple(sorted(self.mat_plan.dropped)))
        return (self.budget_bytes, ())

    # ------------------------------------------------------------------ #
    def infer(self, stats: Optional[Dict] = None) -> LineagePlan:
        """Lineage-inference phase: run predicate pushdown (Algorithm 1,
        plus the Algorithm-2 placement optimization when ``stats`` are
        given) over the pipeline plan.

        Args:
            stats: optional per-node :class:`NodeStats` from a prior
                execution (``Executor.run(...).stats``) — enables the
                cardinality-driven placement optimizer.

        Returns:
            LineagePlan: stages to materialize plus per-source-table
            predicates; also stored on ``self.lineage_plan``.
        """
        t0 = time.perf_counter()
        inf = LineageInference(
            self.plan,
            self.executor.schemas(),
            stats=stats,
            optimize_placement=self.optimize_placement and stats is not None,
            precise_minmax=self.precise_minmax,
        )
        self.lineage_plan = inf.infer()
        self.infer_seconds = time.perf_counter() - t0
        return self.lineage_plan

    def infer_iterative(self) -> IterativePlan:
        """Infer the iterative-refinement plan (Algorithm 3): per-table
        scan predicates refined to a fixpoint at query time, requiring no
        materialized intermediates.

        Returns:
            IterativePlan: refinement stages; also stored on
            ``self.iter_plan``.
        """
        t0 = time.perf_counter()
        self.iter_plan = IterativeInference(self.plan, self.executor.schemas()).infer()
        self.infer_seconds = time.perf_counter() - t0
        return self.iter_plan

    # ------------------------------------------------------------------ #
    def run(self) -> ExecResult:
        """Pipeline execution phase (materializes what the plan requires).

        With a store, stages materialize *encoded* (compressed columnar);
        afterwards the budget planner decides which stages actually fit
        ``budget_bytes`` — the rest are evicted and their dependent source
        predicates degrade to the iterative path at query time."""
        if self.lineage_plan is None:
            self.infer()
        self.exec_result = self.executor.run(
            self.plan, materialize=self.lineage_plan.materialize,
            store=self.store, num_partitions=self.num_partitions,
            partition_rows=self.partition_rows,
        )
        if self.store is not None:
            # a user-supplied store may carry its own budget
            budget = (
                self.budget_bytes if self.store.budget_bytes is None
                else self.store.budget_bytes
            )
            self.mat_plan = plan_materialization(
                self.lineage_plan, self.store.sizes(), budget,
                partition_sizes=self.store.partition_sizes(),
                prune_rates=self.store.prune_estimates(),
                cost_model=self.scan_engine.cost_model,
                disk_budget_bytes=self.disk_budget_bytes,
            )
            if self.mat_plan.dropped:
                self.store.evict(self.mat_plan.dropped)
                for nid in self.mat_plan.dropped:
                    self.exec_result.materialized.pop(nid, None)
            self._apply_tiering()
        return self.exec_result

    def _apply_tiering(self) -> None:
        """Move stages between the RAM and disk tiers to match the current
        materialization plan.  Demote/promote never bump the store
        generation (rows are unchanged — only residency and scan cost
        move), so cached lineage answers stay warm across a tier move; the
        ``exec_result.materialized`` references are refreshed so the RAM
        copy of a demoted stage isn't pinned alive."""
        if self.store is None or self.mat_plan is None:
            return
        for nid in self.mat_plan.disk:
            if nid in self.store.stages:
                self.store.demote(nid)
        for nid in self.mat_plan.kept:
            if nid in self.store.stages \
                    and self.store.stages[nid].tier == "disk":
                self.store.promote(nid)
        if self.exec_result is not None:
            for nid, st in self.store.stages.items():
                if nid in self.exec_result.materialized:
                    self.exec_result.materialized[nid] = st

    def run_unmodified(self) -> ExecResult:
        """Run the pipeline as-is (no intermediate results)."""
        self.exec_result = self.executor.run(self.plan)
        return self.exec_result

    def run_delta(
        self, appended: Mapping[str, Union[Table, Mapping[str, Sequence]]]
    ) -> ExecResult:
        """Incremental execution phase: absorb appended source rows without
        re-running the pipeline from scratch.

        ``appended`` maps source-table name to the new rows — either a
        ready :class:`Table` delta (row ids continuing the existing table)
        or a plain column mapping, which is encoded against the current
        catalog table via :func:`~repro_torch.core.table.encode_delta_like`
        (string columns extend the shared dictionary vocabulary).

        The appended rows become fresh partitions with freshly built zone
        maps; materialized stages whose operator prefix is append-safe are
        *extended* by running only the delta through the prefix
        (:meth:`Executor.run_delta` / :meth:`IntermediateStore.put_delta`),
        while non-append-safe stages re-run with the reason recorded in the
        result's :class:`~repro_torch.core.executor.DeltaReport` (surfaced by
        :meth:`explain`).  A pure append run leaves the generation base of
        :meth:`answer_generation` untouched and only moves row watermarks —
        cached answers stay warm and extendable via :meth:`query_delta`.

        Stages the budget planner dropped stay dropped (the delta is not
        re-planned); a run that had to re-run stages re-evicts over the
        grown sizes like :meth:`run` does.
        """
        assert self.lineage_plan is not None and self.exec_result is not None, \
            "run() first"
        deltas: Dict[str, Table] = {}
        for name, d in appended.items():
            if not isinstance(d, Table):
                d = encode_delta_like(self.catalog[name], d)
            deltas[name] = d
        mat = dict(self.lineage_plan.materialize)
        dropped = self.mat_plan.dropped if self.mat_plan is not None else set()
        for nid in dropped:
            mat.pop(nid, None)
        self.exec_result = self.executor.run_delta(
            self.plan, deltas, materialize=mat, store=self.store,
            num_partitions=self.num_partitions,
            partition_rows=self.partition_rows, prev=self.exec_result,
        )
        if (self.store is not None and self.exec_result.delta is not None
                and self.exec_result.delta.full_invalidation):
            # stage re-runs changed sizes wholesale: re-plan the budget as a
            # full run() would (pure appends skip this — eviction would
            # needlessly invalidate warm answers)
            budget = (self.budget_bytes if self.store.budget_bytes is None
                      else self.store.budget_bytes)
            missing = ({s.node_id for s in self.lineage_plan.stages}
                       - set(self.store.stages))
            self.mat_plan = plan_materialization(
                self.lineage_plan, self.store.sizes(), budget,
                unavailable=missing,
                partition_sizes=self.store.partition_sizes(),
                prune_rates=self.store.prune_estimates(),
                cost_model=self.scan_engine.cost_model,
                disk_budget_bytes=self.disk_budget_bytes,
            )
            if self.mat_plan.dropped:
                self.store.evict(self.mat_plan.dropped)
                for nid in self.mat_plan.dropped:
                    self.exec_result.materialized.pop(nid, None)
            self._apply_tiering()
        elif self.store is not None:
            # a pure append rebuilds extended stages in RAM (put_delta):
            # re-demote the ones the plan holds on the disk tier
            self._apply_tiering()
        return self.exec_result

    def attach_store(self, store: IntermediateStore) -> None:
        """Adopt ``store`` (e.g. reloaded via ``checkpoint.store_io``) as this
        plan's materialized intermediates, so later queries read the spilled
        encoded stages instead of re-materializing the pipeline."""
        assert self.exec_result is not None, "run() or run_unmodified() first"
        if self.lineage_plan is None:
            self.infer()
        self.store = store
        budget = self.budget_bytes if store.budget_bytes is None else store.budget_bytes
        self.exec_result.store = store
        self.exec_result.materialized = dict(store.stages)
        # stages the spilled store no longer holds (evicted before the spill)
        # are unavailable regardless of budget, as is anything downstream of
        # them in the param-binding chain
        missing = {s.node_id for s in self.lineage_plan.stages} - set(store.stages)
        self.mat_plan = plan_materialization(
            self.lineage_plan, store.sizes(), budget, unavailable=missing,
            partition_sizes=store.partition_sizes(),
            prune_rates=store.prune_estimates(),
            cost_model=self.scan_engine.cost_model,
            disk_budget_bytes=self.disk_budget_bytes,
        )
        if self.mat_plan.dropped:
            store.evict(self.mat_plan.dropped)
            for nid in self.mat_plan.dropped:
                self.exec_result.materialized.pop(nid, None)
        self._apply_tiering()

    # ------------------------------------------------------------------ #
    def _output_binding(
        self,
        t_o: Union[int, Dict[str, object]],
        out_params: Optional[Dict[str, str]] = None,
    ) -> Dict[str, object]:
        assert self.exec_result is not None, "run() first"
        out = self.exec_result.output
        lp_params = out_params if out_params is not None else (
            self.lineage_plan.out_params if self.lineage_plan else self.iter_plan.out_params
        )
        binding: Dict[str, object] = {}
        if isinstance(t_o, int):
            row = {c: out.cols[c][t_o] for c in out.columns}
        else:
            row = {c: out.encode_value(c, v) if isinstance(v, str) else v for c, v in t_o.items()}
        for p, col in lp_params.items():
            if col in row:
                v = row[col]
                binding[p] = v.item() if hasattr(v, "item") else v
        return binding

    def _ensure_iter_plan(self) -> IterativePlan:
        """Lazily infer the iterative plan exactly once, even when concurrent
        query threads reach the superset fallback together."""
        if self.iter_plan is None:
            with self._lazy_lock:
                if self.iter_plan is None:
                    self.infer_iterative()
        return self.iter_plan

    def _superset_refine(self, t_o: Union[int, Dict[str, object]]) -> RefineResult:
        """Iterative refinement (Algorithm 3) used as the per-table fallback
        when budget-dropped stages leave source-predicate params unbound."""
        self._ensure_iter_plan()
        binding = self._output_binding(t_o, self.iter_plan.out_params)
        return refine(self.iter_plan, self.catalog, binding,
                      scan=lambda p, t, b: self._scan(p, t, b))

    def _stage_select(self, st: Stage, stobj, binding, param_stage, stage_sel,
                      param_col) -> Table:
        """Matching stage rows as a (small) Table.  Encoded stages scan
        in situ when the binding shape is a plain conjunction (the common
        case) and only the selected rows are decoded via gather; the
        tuple/row-wise binding shapes fall back to the decoded table."""
        scan = self._scan
        if isinstance(stobj, StoredTable) and self.store is not None:
            tg, rw = _binding_groups(st.run_pred, binding, param_stage)
            if not tg and not rw:
                m = self.store.scan(st.node_id, st.run_pred, binding,
                                    self.scan_engine)
                return stobj.take(np.nonzero(m)[0])
            table = stobj.to_table()
        else:
            table = stobj
        m = _eval_pred(st.run_pred, table, binding, param_stage, stage_sel,
                       param_col, scan=scan)
        return table.mask(m)

    def query(self, t_o: Union[int, Dict[str, object]]) -> LineageAnswer:
        """Precise lineage via materialized intermediates (Algorithm 1).

        With a byte-budgeted store, source predicates that depend on a
        dropped stage's params degrade *per table* to the iterative/superset
        path (``detail["superset_tables"]``); everything whose stage chain is
        still materialized stays precise."""
        assert self.lineage_plan is not None and self.exec_result is not None
        t0 = time.perf_counter()
        binding = self._output_binding(t_o)
        scan = self._scan
        lp = self.lineage_plan
        dropped = self.mat_plan.dropped if self.mat_plan is not None else set()
        detail: Dict[str, object] = {}

        # nothing materialized at all (budget 0): the whole query is the
        # iterative path — identical to ``query_iterative``
        if lp.stages and len(dropped) >= len(lp.stages):
            rr = self._superset_refine(t_o)
            detail["superset_tables"] = sorted({sp.table for sp in lp.source_preds})
            detail["iterations"] = rr.iterations
            lin = dict(rr.lineage)
            return LineageAnswer(lin, time.perf_counter() - t0, detail,
                                 precise={t: False for t in lin})

        # walk the stage chain, binding parameters from selected rows
        available = set(binding)
        param_stage: Dict[str, int] = {}
        param_col: Dict[str, str] = {}
        stage_sel: Dict[int, Table] = {}
        used_stage_nodes: set = set()
        for si, st in enumerate(lp.stages):
            if st.node_id in dropped:
                continue
            if (params_of(st.run_pred) | set(st.guards)) - available:
                continue  # depends on a dropped stage: unusable
            stobj = self.exec_result.materialized.get(st.node_id)
            if stobj is None:
                continue
            if not st.params_out:
                # certification-only stage (opaque boundary): it binds no
                # params, so its selection is never consumed — availability
                # alone certifies the tables below it
                used_stage_nodes.add(st.node_id)
                continue
            if any(_guard_dead(binding.get(g)) for g in st.guards):
                if isinstance(stobj, StoredTable):
                    sel = stobj.take(np.empty(0, dtype=np.int64))
                else:
                    sel = stobj.mask(np.zeros(stobj.nrows, dtype=bool))
            else:
                sel = self._stage_select(st, stobj, binding, param_stage,
                                         stage_sel, param_col)
            stage_sel[si] = sel
            used_stage_nodes.add(st.node_id)
            for p, colname in st.params_out.items():
                if colname in sel.cols:
                    binding[p] = _clean_binding_value(_uniq(sel.cols[colname]))
                    param_stage[p] = si
                    param_col[p] = colname
                    available.add(p)

        lineage: Dict[str, np.ndarray] = {}
        fallback: set = set()
        for sp in lp.source_preds:
            if (params_of(sp.pred) | set(sp.guards)) - available:
                fallback.add(sp.table)  # unbound params: superset path below
                continue
            t = self.catalog[sp.table]
            if sp.pred == FALSE or any(_guard_dead(binding.get(g)) for g in sp.guards):
                rids = np.array([], dtype=np.int64)
            else:
                m = _eval_pred(sp.pred, t, binding, param_stage, stage_sel,
                               param_col, scan=scan)
                rids = t.rids()[m]
            lineage[sp.table] = (
                np.union1d(lineage[sp.table], rids) if sp.table in lineage else np.unique(rids)
            )
        if fallback:
            rr = self._superset_refine(t_o)
            for tab in sorted(fallback):
                rids = np.asarray(rr.lineage.get(tab, np.array([], dtype=np.int64)))
                lineage[tab] = (
                    np.union1d(lineage[tab], rids) if tab in lineage else rids
                )
            detail["iterations"] = rr.iterations
        # a mandatory (opaque-UDF) stage that could not run — budget-dropped
        # or missing from a reloaded store — leaves every table below it
        # uncertified: the answer there is the well-defined whole-input
        # superset, never an under-approximation
        superset_set = set(fallback)
        for nid, tabs in lp.superset_scope.items():
            if nid not in used_stage_nodes:
                superset_set.update(tabs)
        if superset_set:
            detail["superset_tables"] = sorted(superset_set)
        ans = LineageAnswer(lineage, time.perf_counter() - t0, detail,
                            precise={t: t not in superset_set for t in lineage})
        if not superset_set and not fallback:
            # precise, fully materialized answer: stash the final binding
            # chain so a later append-only run can extend it in place
            ans.delta_ctx = (binding, param_stage, param_col, stage_sel)
        return ans

    # ------------------------------------------------------------------ #
    def query_delta(self, cached: LineageAnswer,
                    old_token) -> Optional[LineageAnswer]:
        """Extend a cached precise answer across append-only delta runs.

        ``cached`` must be an answer this PredTrace produced earlier (its
        stashed binding chain is reused) and ``old_token`` the
        :meth:`answer_generation` token it was stamped with.  When the
        current token is :func:`delta_compatible` — same generation base,
        row watermarks only moved forward — the lineage is brought up to
        date by rescanning *only* the delta regions: each materialized
        stage's appended rows are checked against the cached binding (any
        match would rebind downstream params, so the extension bails), then
        each source predicate scans just the fresh partitions
        (:func:`~repro_torch.core.table.delta_view`) with zone-map pruning, and
        newly matching row ids are unioned into the cached lineage.  An
        output row whose pruned partition set is untouched by the append is
        served with zero rescanned partitions.

        Returns the extended answer — ``detail["delta"]`` carries
        rescanned-vs-warm partition counts — or ``None`` when the cached
        answer cannot be soundly extended (base mismatch, imprecise or
        budget-degraded answer, or a stage delta matched); the caller then
        falls back to a full :meth:`query`.
        """
        new_token = self.answer_generation()
        if not delta_compatible(old_token, new_token):
            return None
        ctx = cached.delta_ctx
        if (ctx is None or not cached.all_precise()
                or cached.detail.get("superset_tables")):
            return None
        if self.mat_plan is not None and self.mat_plan.dropped:
            return None
        from .cost import prog_atoms

        t0 = time.perf_counter()
        binding, param_stage, param_col, sel = ctx
        stage_sel = sel() if callable(sel) else sel
        old = {m[:2]: m[2] for m in old_token[1]}
        lp = self.lineage_plan
        cm = self.scan_engine.cost_model
        # binding-independent predicate analysis, computed once per plan —
        # the warm path answers many bindings against the same predicates
        cached_an = getattr(self, "_delta_an", None)
        if cached_an is None or cached_an[0] is not lp:
            an = {}
            for i, sp in enumerate(lp.source_preds):
                pair = (params_of(sp.pred), _eq_only_params(sp.pred))
                an["src", i] = (pair[0] | set(sp.guards), pair)
            for st in lp.stages:
                pair = (params_of(st.run_pred), _eq_only_params(st.run_pred))
                an["st", int(st.node_id)] = (pair[0] | set(st.guards), pair)
            cached_an = self._delta_an = (lp, an)
        an = cached_an[1]

        # 1. stage deltas: a new stage row matching the cached binding would
        # rebind downstream params, invalidating the cached chain — bail to
        # a full query.  (Old stage rows never change on the append path.)
        for st in lp.stages:
            if not st.params_out:
                continue
            stobj = self.exec_result.materialized.get(st.node_id)
            if stobj is None:
                return None
            old_n = old.get(("s", int(st.node_id)))
            if old_n is None:
                return None
            new_n = int(stobj.nrows)
            if new_n == old_n:
                continue
            needed, st_pair = an["st", int(st.node_id)]
            if needed - set(binding):
                return None
            if any(_guard_dead(binding.get(g)) for g in st.guards):
                continue  # selection is empty regardless of appended rows
            vkey = (table_uid(stobj), old_n, new_n)
            vcache = getattr(self, "_delta_views", None)
            if vcache is None:
                vcache = self._delta_views = {}
            view = vcache.get(vkey)
            if view is None:
                if len(vcache) > 64:
                    vcache.clear()
                if isinstance(stobj, StoredTable):
                    view = stobj.take(np.arange(old_n, new_n))
                else:
                    view = Table({k: np.asarray(v)[old_n:new_n]
                                  for k, v in stobj.cols.items()},
                                 stobj.dicts, stobj.name)
                vcache[vkey] = view
            m = _eval_pred(st.run_pred, view, binding, param_stage,
                           stage_sel, param_col, analysis=st_pair)
            if m.any():
                return None  # stage_delta_match: binding would change

        # 2. source predicates: scan only the delta view, union new rids
        lineage: Dict[str, np.ndarray] = dict(cached.lineage)
        tables_detail: Dict[str, Dict[str, int]] = {}
        for sp_i, sp in enumerate(lp.source_preds):
            needed, sp_pair = an["src", sp_i]
            if needed - set(binding):
                return None
            t = self.catalog[sp.table]
            old_n = old.get(("t", sp.table))
            if old_n is None:
                return None
            total_parts = (t.num_partitions
                           if isinstance(t, PartitionedTable) else 1)
            td = tables_detail.setdefault(
                sp.table, {"delta_rows": int(t.nrows - old_n),
                           "new_rids": 0, "rescanned_partitions": 0,
                           "warm_partitions": total_parts})
            if t.nrows == old_n:
                continue  # untouched table: fully warm
            if sp.pred == FALSE or any(
                    _guard_dead(binding.get(g)) for g in sp.guards):
                continue  # dead predicate matched nothing before or now
            # keyed by monotone table uid (never recycled), so an appended
            # table can never alias a stale cached view
            vkey = (table_uid(t), old_n, int(t.nrows))
            vcache = getattr(self, "_delta_views", None)
            if vcache is None:
                vcache = self._delta_views = {}
            view = vcache.get(vkey)
            if view is None:
                if len(vcache) > 64:
                    vcache.clear()
                view, _off = delta_view(t, old_n)
                vcache[vkey] = view
            prog, atoms = None, 1
            try:
                prog = self.scan_engine.compile(sp.pred)
                atoms = prog_atoms(prog)
            except (KeyError, TypeError, ValueError):
                pass
            alive = None
            if (prog is not None and isinstance(view, PartitionedTable)
                    and view.num_partitions > 0):
                try:
                    alive = prune_zone_maps(prog, view.zone_maps, binding)
                except (KeyError, TypeError, ValueError):
                    alive = None
            if alive is not None and not alive.any():
                # every fresh partition provably empty for this binding: the
                # answer's pruned partition set is untouched — zero rescans
                continue
            choice = cm.choose(
                f"delta:{sp.table}",
                [("delta_rescan", float(view.nrows) * atoms),
                 ("serial", float(t.nrows) * atoms)],
                meta={"table": sp.table, "delta_rows": int(view.nrows),
                      "total_rows": int(t.nrows)},
            )
            scan_t = t if choice.route == "serial" else view
            t1 = time.perf_counter()
            # both routes scan through the engine, so a delta view's scan
            # takes the same device-or-host decision as any other table
            # (the reference evaluates delta views with the host tree
            # evaluator; the answers are the same)
            m = _eval_pred(sp.pred, scan_t, binding, param_stage, stage_sel,
                           param_col, scan=self._scan, analysis=sp_pair)
            rids = scan_t.rids()[m]
            choice.done(time.perf_counter() - t1)
            if choice.route == "serial":
                scanned = total_parts
            elif alive is not None:
                scanned = int(alive.sum())
            else:
                scanned = (view.num_partitions
                           if isinstance(view, PartitionedTable) else 1)
            td["rescanned_partitions"] = max(td["rescanned_partitions"],
                                             scanned)
            td["warm_partitions"] = total_parts - td["rescanned_partitions"]
            if len(rids):
                prev = lineage.get(sp.table, np.array([], dtype=np.int64))
                before = len(prev)
                lineage[sp.table] = np.union1d(prev, np.unique(rids))
                td["new_rids"] += int(len(lineage[sp.table]) - before)

        detail: Dict[str, object] = {"delta": {
            "rescanned_partitions": sum(
                d["rescanned_partitions"] for d in tables_detail.values()),
            "warm_partitions": sum(
                d["warm_partitions"] for d in tables_detail.values()),
            "tables": tables_detail,
        }}
        ans = LineageAnswer(lineage, time.perf_counter() - t0, detail,
                            precise={t: True for t in lineage})
        ans.delta_ctx = (binding, param_stage, param_col, stage_sel)
        return ans

    # ------------------------------------------------------------------ #
    def explain(self, t_o: Union[int, Dict[str, object]]) -> "PlanReport":
        """Run ``query(t_o)`` with plan recording on and return the full
        :class:`~repro_torch.core.cost.PlanReport`.

        The report holds, per source table, the plan alternatives the
        engine weighs (precise scan / iterative inference / whole-input
        superset) with their estimated costs and the chosen verdict; every
        scan-dispatch decision made during the query (candidates considered,
        estimated vs measured seconds, fallbacks); and the cost-model
        summary (per-route parameters, estimate-error stats, feedback
        flags).  Recording never changes the answer: the lineage returned
        under ``explain`` is bit-identical to a plain ``query``.

        Args:
            t_o: output row selector — an output row index (``int``) or a
                column-value dict, exactly as :meth:`query` takes it.

        Returns:
            PlanReport: structured plan/cost breakdown.  ``to_dict()`` /
            ``to_json()`` are the stable serialized forms, ``pretty()`` the
            human rendering; ``report.answer`` carries the live
            :class:`LineageAnswer`, whose ``plan`` field points back at the
            report.
        """
        from .cost import PlanRecorder

        with PlanRecorder() as rec:
            ans = self.query(t_o)
        report = self._build_report(rec.decisions, ans)
        report.answer = ans
        ans.plan = report
        return report

    def _build_report(self, decisions, ans: LineageAnswer) -> "PlanReport":
        """Assemble a :class:`~repro_torch.core.cost.PlanReport` from one query's
        recorded dispatch decisions plus its answer."""
        from .cost import BASE_OVERHEAD_S, PlanReport, prog_atoms

        cm = self.scan_engine.cost_model
        superset = set(ans.detail.get("superset_tables", ()))
        iters = int(ans.detail.get("iterations", 0))
        preds: Dict[str, list] = {}
        if self.lineage_plan is not None:
            for sp in self.lineage_plan.source_preds:
                preds.setdefault(sp.table, []).append(sp.pred)
        tables: Dict[str, Dict[str, object]] = {}
        for tab, rids in sorted(ans.lineage.items()):
            t = self.catalog.get(tab)
            n = int(t.nrows) if t is not None else 0
            atoms = 1
            for p in preds.get(tab, ()):
                try:
                    atoms = max(atoms, prog_atoms(self.scan_engine.compile(p)))
                except (KeyError, TypeError, ValueError):
                    pass
            w = float(n) * atoms
            precise_ok = tab not in superset
            verdict = ("precise" if ans.precise.get(tab, True)
                       else ("iterative" if iters else "superset"))
            # iterative refinement re-scans until fixpoint: charge the
            # observed iteration count (or the typical three passes)
            passes = max(iters, 3)
            alts = [
                {"plan": "precise", "viable": precise_ok,
                 "est_s": cm.estimate("serial", w),
                 "chosen": verdict == "precise"},
                {"plan": "iterative", "viable": True,
                 "est_s": passes * cm.estimate("serial", w),
                 "chosen": verdict == "iterative"},
                {"plan": "superset", "viable": True,
                 "est_s": BASE_OVERHEAD_S,
                 "chosen": verdict == "superset"},
            ]
            tables[tab] = {
                "verdict": verdict, "rows": n,
                "lineage_rows": int(len(rids)),
                "atoms": atoms, "alternatives": alts,
            }
        mp = self.mat_plan
        pipeline = {
            "budget_bytes": (self.budget_bytes if mp is None
                             else mp.budget_bytes),
            "num_partitions": self.num_partitions,
            "partition_rows": self.partition_rows,
            "backend": type(self.scan_engine.backend).__name__,
            "parallel": self.partition_exec is not None,
            "stages": (len(self.lineage_plan.stages)
                       if self.lineage_plan is not None else 0),
            "stages_dropped": len(mp.dropped) if mp is not None else 0,
        }
        if mp is not None and (mp.disk or mp.disk_budget_bytes != 0):
            # out-of-core tier: which stages the planner demoted (still
            # precise, memmap-scanned) and the store's residency/IO counters
            pipeline["disk_budget_bytes"] = mp.disk_budget_bytes
            pipeline["stages_disk"] = sorted(mp.disk)
            if self.store is not None:
                pipeline["tiers"] = self.store.tier_summary()
        if self.exec_result is not None and self.exec_result.delta is not None:
            # most recent run_delta: per-stage extend/rerun actions with the
            # append-unsafety reasons, and the store's fast-append counters
            pipeline["delta"] = self.exec_result.delta.to_dict()
            if self.store is not None:
                pipeline["delta"]["store"] = dict(self.store.delta_stats)
        routes: Dict[str, int] = {}
        for d in decisions:
            routes[d.chosen] = routes.get(d.chosen, 0) + 1
        cm_snap = cm.snapshot()
        summary = {
            "query_seconds": float(ans.seconds),
            "scan_decisions": len(decisions),
            "total_est_s": float(sum(d.est_s for d in decisions)),
            "total_actual_s": float(sum(d.actual_s or 0.0
                                        for d in decisions)),
            "routes": routes,
            "estimate_error": cm.error_summary(),
            "flags": cm_snap.get("flags", []),
            "cost_model": cm_snap,
        }
        return PlanReport(pipeline=pipeline, tables=tables,
                          scans=list(decisions), summary=summary)

    # ------------------------------------------------------------------ #
    def query_batch(
        self, rows: Sequence[Union[int, Dict[str, object]]]
    ) -> List[LineageAnswer]:
        """Batched lineage querying: answer N output rows in ONE scan per
        table.  Stage predicates and source predicates are evaluated for all
        target rows together via :meth:`ScanEngine.scan_batch` (static atoms
        once, equality thresholds vectorized); rows whose bindings need the
        row-wise / tuple-membership treatment fall back to the per-row
        evaluator, so answers are always identical to ``query(row)``."""
        assert self.lineage_plan is not None and self.exec_result is not None
        t0 = time.perf_counter()
        B = len(rows)
        if B == 0:
            return []
        if self.mat_plan is not None and self.mat_plan.dropped:
            # budget-degraded plans mix precise and iterative answers per
            # table; answer row-by-row (query() owns that logic)
            return [self.query(r) for r in rows]
        bindings = [self._output_binding(r) for r in rows]
        scan = self._scan

        param_stage: Dict[str, int] = {}
        param_col: Dict[str, str] = {}
        stage_tables: Dict[int, Table] = {}
        stage_idxs: List[Dict[int, np.ndarray]] = [{} for _ in range(B)]
        empty = np.array([], dtype=np.int64)

        sel_tables: List[Dict[int, Table]] = [{} for _ in range(B)]

        def stage_sels(b: int) -> Dict[int, Table]:
            """Materialized stage selections for one target row — built (and
            cached) only for the bindings that need the row-wise/tuple
            evaluator; a stage's selection never changes once computed."""
            cache = sel_tables[b]
            for si, idx in stage_idxs[b].items():
                if si not in cache:
                    cache[si] = stage_tables[si].take(idx)
            return cache

        def sel_col(b: int, sid: int, p: str) -> np.ndarray:
            """A stage-selection column for one target row, without
            materializing the selection Table."""
            return stage_tables[sid].cols[param_col[p]][stage_idxs[b][sid]]

        def tuple_batch(pred, table, entries) -> Optional[Dict[int, np.ndarray]]:
            """Batched tuple-group evaluation for rows sharing one group
            signature — mirrors ``_eval_pred``'s zip-semantics path, but the
            leading membership of every group runs against the engine's
            sorted index instead of a full-table ``isin`` per row.  Returns
            None when the shape isn't batchable (atom-less group)."""
            bs = [b for b, _ in entries]
            tg = entries[0][1]
            conj = conjuncts(pred)
            consumed: List[Expr] = []
            groups: List[Tuple[int, List[Tuple[Expr, str]]]] = []
            for sid, plist in tg.items():
                atoms: List[Tuple[Expr, str]] = []
                for a in conj:
                    ap = params_of(a)
                    if len(ap) == 1 and next(iter(ap)) in plist and isinstance(a, BinOp):
                        p = next(iter(ap))
                        lhs = a.left if isinstance(a.right, Param) else a.right
                        atoms.append((lhs, p))
                        consumed.append(a)
                if not atoms:
                    return None  # membership-only group: leave to _eval_pred
                groups.append((sid, atoms))
            rest = [a for a in conj if a not in consumed]
            rest_pred = None
            if rest:
                from .expr import land

                rest_pred = land(*rest)
                rest_cols = [c for c in cols_of(rest_pred) if c in table.cols]

            def lhs_vals(lhs, idx):
                if isinstance(lhs, Col):
                    return table.cols[lhs.name][idx]
                env = {c: table.cols[c][idx] for c in cols_of(lhs)}
                return np.asarray(eval_np(lhs, env, {}, n=len(idx)))

            out: Dict[int, np.ndarray] = {}
            for sid, atoms in groups:
                lhs0, p0 = atoms[0]
                cand0 = self.scan_engine.member_batch_idx(
                    table, lhs0, [sel_col(b, sid, p0) for b in bs]
                )
                for j, b in enumerate(bs):
                    idx = cand0[j]
                    vals = [lhs_vals(lhs0, idx)]
                    for lhs, p in atoms[1:]:
                        if not len(idx):
                            break
                        v = lhs_vals(lhs, idx)
                        keep = np.isin(v, np.unique(sel_col(b, sid, p)))
                        idx = idx[keep]
                        vals = [lv[keep] for lv in vals]
                        vals.append(v[keep])
                    if len(atoms) > 1 and len(idx):
                        from .executor import composite_codes

                        ct, cs = composite_codes(
                            vals, [np.asarray(sel_col(b, sid, p)) for _, p in atoms]
                        )
                        idx = idx[np.isin(ct, cs)]
                    out[b] = idx if b not in out else np.intersect1d(out[b], idx)
            if rest_pred is not None:
                for b in bs:
                    idx = out[b]
                    if not len(idx):
                        continue
                    env = {c: table.cols[c][idx] for c in rest_cols}
                    keep = np.asarray(
                        eval_np(rest_pred, env, bindings[b], n=len(idx)), bool
                    )
                    out[b] = idx[keep]
            return out

        def batch_indices(pred, table, guards) -> List[Optional[np.ndarray]]:
            """Matching row indices per target row; None marks guard-dead rows."""
            dead = [
                any(_guard_dead(bindings[b].get(g)) for g in guards)
                for b in range(B)
            ]
            analysis = (params_of(pred), _eq_only_params(pred))
            simple: List[int] = []
            per_row: List[int] = []
            tuple_groups: Dict[Tuple, List[Tuple[int, Dict]]] = {}
            idxs: List[Optional[np.ndarray]] = [None] * B
            for b in range(B):
                if dead[b]:
                    continue
                tg, rw = _binding_groups(pred, bindings[b], param_stage, analysis)
                if rw:  # row-wise binding: exact per-row evaluation
                    per_row.append(b)
                elif tg:  # tuple groups: batchable by group signature
                    sig = tuple(sorted(
                        (sid, tuple(sorted(plist))) for sid, plist in tg.items()
                    ))
                    tuple_groups.setdefault(sig, []).append((b, tg))
                else:
                    simple.append(b)
            for entries in tuple_groups.values():
                res = tuple_batch(pred, table, entries)
                if res is None:
                    per_row.extend(b for b, _ in entries)
                else:
                    for b, idx in res.items():
                        idxs[b] = idx
            for b in per_row:
                m = _eval_pred(pred, table, bindings[b], param_stage,
                               stage_sels(b), param_col, scan=scan)
                idxs[b] = np.nonzero(m)[0]
            if simple:
                batched = self.scan_engine.scan_batch_idx(
                    pred, table, [bindings[b] for b in simple]
                )
                for b, idx in zip(simple, batched):
                    idxs[b] = idx
            return idxs

        for si, st in enumerate(self.lineage_plan.stages):
            if not st.params_out:
                continue  # certification-only stage: binds nothing
            table = self.exec_result.materialized[st.node_id]
            if isinstance(table, StoredTable):
                # the batch path leans on the engine's identity-keyed sorted
                # indexes; read the store through its cached decoded view
                table = table.to_table()
            stage_tables[si] = table
            idxs = batch_indices(st.run_pred, table, st.guards)
            lens = np.fromiter(
                (0 if idx is None else len(idx) for idx in idxs), np.int64, B
            )
            offs = np.zeros(B, dtype=np.int64)
            np.cumsum(lens[:-1], out=offs[1:])
            flat = (
                np.concatenate([idx for idx in idxs if idx is not None and len(idx)])
                if lens.sum() else empty
            )
            for b in range(B):
                stage_idxs[b][si] = empty if idxs[b] is None else idxs[b]
            for p, colname in st.params_out.items():
                if colname not in table.cols:
                    continue
                param_stage[p] = si
                param_col[p] = colname
                col = table.cols[colname]
                colf = col[flat]
                nonempty = np.nonzero(lens)[0]
                if len(nonempty):
                    # segment min == max detects the common constant-column
                    # case without a per-row unique.  reduceat runs over the
                    # non-empty segments' offsets only: they are strictly
                    # increasing and in range, and consecutive non-empty
                    # offsets are exact segment boundaries (empty segments
                    # contribute no elements), so no clipping is needed —
                    # clipping would shift the last segment's boundary.
                    mins = np.minimum.reduceat(colf, offs[nonempty])
                    maxs = np.maximum.reduceat(colf, offs[nonempty])
                    seg = np.full(B, -1, dtype=np.int64)
                    seg[nonempty] = np.arange(len(nonempty))
                fkind = col.dtype.kind == "f"
                ikind = col.dtype.kind in "iu"
                for b in range(B):
                    ln = lens[b]
                    if ln == 0:
                        bindings[b][p] = col[:0]
                    elif ln == 1 or mins[seg[b]] == maxs[seg[b]]:  # constant
                        v = colf[offs[b]]
                        if (fkind and np.isnan(v)) or (ikind and v == -1):
                            bindings[b][p] = col[:0]  # null sentinel: dead
                        else:
                            bindings[b][p] = v.item()
                    else:
                        bindings[b][p] = _clean_binding_value(
                            np.unique(colf[offs[b]:offs[b] + ln])
                        )

        lineages: List[Dict[str, np.ndarray]] = [{} for _ in range(B)]
        for sp in self.lineage_plan.source_preds:
            t = self.catalog[sp.table]
            if sp.pred == FALSE:
                idxs = [None] * B
            else:
                idxs = batch_indices(sp.pred, t, sp.guards)
            for b in range(B):
                idx = idxs[b]
                rids = empty if idx is None else t.rids()[idx]
                lin = lineages[b]
                if sp.table in lin:
                    lin[sp.table] = np.union1d(lin[sp.table], rids)
                else:
                    # candidate indices are distinct by construction; rids of
                    # a source table are unique per row — sort suffices
                    rids.sort()
                    lin[sp.table] = rids
        dt = time.perf_counter() - t0
        out = []
        for b in range(B):
            # the batch path only runs with every stage materialized
            # (degraded plans fall back to per-row query() above), so every
            # answer is certified precise
            ans = LineageAnswer(lineages[b], dt / B,
                                precise={t: True for t in lineages[b]})
            ans.detail["batch"] = B
            # stage selections build lazily: query_delta only consults them
            # for the tuple/row-wise binding shapes
            ans.delta_ctx = (bindings[b], param_stage, param_col,
                             (lambda b=b: stage_sels(b)))
            out.append(ans)
        return out

    # ------------------------------------------------------------------ #
    def query_iterative(
        self, t_o: Union[int, Dict[str, object]], max_iters: int = 32, scan=None
    ) -> LineageAnswer:
        """Algorithm 3: no intermediate results; may return a superset."""
        self._ensure_iter_plan()
        if self.exec_result is None:
            self.run_unmodified()
        t0 = time.perf_counter()
        # bind via the iterative plan's own params: a PredTrace that also ran
        # infer() has a second, differently-named out-param set
        binding = self._output_binding(t_o, self.iter_plan.out_params)
        if scan is None:
            scan = lambda pred, t, b: self._scan(pred, t, b)
        rr: RefineResult = refine(self.iter_plan, self.catalog, binding, max_iters, scan=scan)
        # Algorithm 3's contract is a sound superset; the refinement does not
        # certify exactness, so every table is flagged imprecise
        ans = LineageAnswer(rr.lineage, time.perf_counter() - t0,
                            precise={t: False for t in rr.lineage})
        ans.detail["iterations"] = rr.iterations
        ans.detail["masks"] = rr.masks
        ans.detail["naive_masks"] = rr.naive_masks
        return ans

    def query_naive(self, t_o: Union[int, Dict[str, object]]) -> LineageAnswer:
        """Naive pushdown baseline for Table 6: phase-1 predicates only."""
        self._ensure_iter_plan()
        if self.exec_result is None:
            self.run_unmodified()
        t0 = time.perf_counter()
        binding = self._output_binding(t_o, self.iter_plan.out_params)
        lineage: Dict[str, np.ndarray] = {}
        for sid, (tab, pred) in self.iter_plan.g1.items():
            t = self.catalog[tab]
            m = self._scan(pred, t, binding)
            rids = t.rids()[m]
            lineage[tab] = (
                np.union1d(lineage[tab], rids) if tab in lineage else np.unique(rids)
            )
        return LineageAnswer(lineage, time.perf_counter() - t0,
                             precise={t: False for t in lineage})


def _guard_dead(v) -> bool:
    if v is None:
        return False
    if isinstance(v, np.ndarray):
        return len(v) == 0
    return _is_null(v)
