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
``core/scan.py``.  The reference's worker-pool / mesh partition runtime, its
incremental (``run_delta``) path and its disk tier are not part of this
package yet: asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

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
from .scan import ScanEngine
from .store import IntermediateStore, StoredTable
from .table import PartitionedTable, Table, partition_table


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

    def total_rows(self) -> int:
        return int(sum(len(v) for v in self.lineage.values()))

    def all_precise(self) -> bool:
        """Is every table's lineage certified exact (no superset fallback)?"""
        return all(self.precise.get(t, True) for t in self.lineage)


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
    the iterative/superset path) and fixed-size partitioning with zone-map
    pruning — answers are identical under every configuration."""

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
            disk_budget_bytes: second-tier (disk) byte budget; only ``0``
                (tier disabled) is supported yet.
            num_partitions / partition_rows: fixed-size partition layout
                with zone maps; lineage scans prune partitions first.
            parallel / mesh: the partition runtime's worker pool and device
                mesh; not supported yet (must be left unset).
            device: torch device of the scans when ``scan_engine`` is
                omitted — ``None`` is the CUDA card (raises without one),
                ``"cpu"`` runs the kernel's plain PyTorch version.
        """
        if parallel or mesh is not None:
            raise NotImplementedError(
                "parallel / mesh partition runtime is not ported yet")
        if disk_budget_bytes != 0:
            raise NotImplementedError("the disk tier is not ported yet")
        # partitioned table runtime: with ``num_partitions``/``partition_rows``
        # every source table (and every materialized stage) is split into
        # fixed-size row chunks carrying zone maps; lineage-query scans prune
        # whole chunks before any row-level work.  Answers are identical
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
        if store is True or (store is None and budget_bytes is not None):
            store = IntermediateStore(budget_bytes,
                                      num_partitions=num_partitions,
                                      part_rows=partition_rows)
        self.store: Optional[IntermediateStore] = (
            store if isinstance(store, IntermediateStore) else None
        )
        self.budget_bytes = budget_bytes
        # one scan entry point for every query path
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
            )
            if self.mat_plan.dropped:
                self.store.evict(self.mat_plan.dropped)
                for nid in self.mat_plan.dropped:
                    self.exec_result.materialized.pop(nid, None)
        return self.exec_result

    def run_unmodified(self) -> ExecResult:
        """Run the pipeline as-is (no intermediate results)."""
        self.exec_result = self.executor.run(self.plan)
        return self.exec_result

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
        return LineageAnswer(lineage, time.perf_counter() - t0, detail,
                             precise={t: t not in superset_set for t in lineage})

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
            "parallel": False,
            "stages": (len(self.lineage_plan.stages)
                       if self.lineage_plan is not None else 0),
            "stages_dropped": len(mp.dropped) if mp is not None else 0,
        }
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
