"""Algorithm 1 — logical lineage inference phase.

Walks the plan output-first, pushing the running predicate through each
operator (``pushdown.py``).  When a pushdown is not precise, the operator's
output is marked for materialization and a fresh parameterized row-selection
predicate is pushed instead (paper Lines 5-7) — which is guaranteed precise
because a node's own output schema always contains its keys.

Materialization *placement* is then optimized by Algorithm 2
(``intermediate.py``): defer to a later (closer-to-output) operator when the
row-selection predicate from there still pushes precisely to all sources
below, and the (column-projected) result is smaller.

The result is a :class:`LineagePlan` — a data-system-independent artifact
computed once per pipeline (paper §3.3): parameterized predicates per source
table plus an ordered chain of (materialized table, predicate, param-binding)
stages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import ops as O
from .executor import NodeStats
from .expr import (
    FALSE,
    BinOp,
    Col,
    Expr,
    Param,
    TRUE,
    cols_of,
    params_of,
    row_selection_for,
)
from .pushdown import Push, Pushdown


@dataclass
class Stage:
    """One materialized intermediate result."""

    node_id: int
    run_pred: Expr  # F_i: runs on the materialized table (params bound earlier)
    params_out: Dict[str, str]  # param -> column of this materialized table
    guards: List[str] = field(default_factory=list)
    keep_cols: Optional[List[str]] = None  # column projection (Algorithm 2)


@dataclass
class SourcePred:
    node_id: int  # Source-node occurrence
    table: str
    pred: Expr
    guards: List[str] = field(default_factory=list)


@dataclass
class LineagePlan:
    plan: O.Node
    out_params: Dict[str, str]  # param -> output column (F_n^row)
    stages: List[Stage]  # binding order: output-first
    source_preds: List[SourcePred]
    # mandatory materialization boundaries (SUPERSET-marker pushes, i.e.
    # opaque UDFs): stage node id -> source tables in its subtree.  With the
    # stage saved, answers stay precise; with it dropped/unavailable, every
    # listed table degrades to a flagged (well-defined) superset.
    superset_scope: Dict[int, List[str]] = field(default_factory=dict)

    @property
    def materialize(self) -> Dict[int, Optional[List[str]]]:
        return {s.node_id: s.keep_cols for s in self.stages}

    @property
    def opaque_stages(self) -> List[int]:
        return sorted(self.superset_scope)

    def describe(self) -> str:  # pragma: no cover - debug aid
        lines = [f"output params: {self.out_params}"]
        for s in self.stages:
            lines.append(f"  materialize node {s.node_id}: run {s.run_pred} -> bind {s.params_out}")
        for sp in self.source_preds:
            lines.append(f"  source {sp.table}#{sp.node_id}: {sp.pred}")
        return "\n".join(lines)


# --------------------------------------------------------------------------- #
# budget-aware materialization planning
# --------------------------------------------------------------------------- #


@dataclass
class MaterializationPlan:
    """Which :class:`LineagePlan` stages to actually keep under a byte budget.

    ``kept`` stages stay in the intermediate store (precise bindings);
    ``disk`` stages don't fit RAM but fit the disk budget — they are
    *demoted* to the out-of-core tier (memmap-backed, still scanned in situ,
    still precise); ``dropped`` stages fit neither and degrade the source
    predicates that depend on their params to the iterative/superset path —
    per stage, not all-or-nothing.

    For partitioned stages the plan also records the partition layout and a
    prune-aware *scan cost*: ``scan_cost[nid]`` estimates the bytes a
    selective lineage query actually touches after zone-map pruning
    (``size * (1 - prune_rate)``), which is what query latency tracks — the
    byte budget governs what is *kept*, the scan cost what a kept stage
    *costs to read*."""

    budget_bytes: Optional[int]
    kept: List[int]
    dropped: Set[int]
    sizes: Dict[int, int]
    partitions: Dict[int, int] = field(default_factory=dict)
    scan_cost: Dict[int, float] = field(default_factory=dict)
    # out-of-core tier: stages demoted to disk, and the budget that admitted
    # them (0 = tier disabled, None = unlimited disk)
    disk: List[int] = field(default_factory=list)
    disk_budget_bytes: Optional[int] = 0

    @property
    def kept_bytes(self) -> int:
        return int(sum(self.sizes.get(nid, 0) for nid in self.kept))

    @property
    def disk_bytes(self) -> int:
        return int(sum(self.sizes.get(nid, 0) for nid in self.disk))

    @property
    def degraded(self) -> bool:
        return bool(self.dropped)

    def kept_scan_cost(self) -> float:
        """Expected bytes touched per query across the kept stages."""
        return float(sum(
            self.scan_cost.get(nid, self.sizes.get(nid, 0)) for nid in self.kept
        ))


def stage_param_deps(lp: "LineagePlan") -> Dict[int, Set[int]]:
    """Stage node-id -> node-ids of earlier stages whose bound params feed its
    run-predicate or guards.  A stage whose dependency is dropped is useless
    (its predicate has permanently unbound params), so the planner drops it
    too."""
    bound_by: Dict[str, int] = {}
    deps: Dict[int, Set[int]] = {}
    for st in lp.stages:
        need = params_of(st.run_pred) | set(st.guards)
        deps[st.node_id] = {bound_by[p] for p in need if p in bound_by}
        for p in st.params_out:
            bound_by.setdefault(p, st.node_id)
    return deps


def plan_materialization(
    lp: "LineagePlan",
    sizes: Dict[int, int],
    budget_bytes: Optional[int],
    unavailable: Optional[Set[int]] = None,
    partition_sizes: Optional[Dict[int, List[int]]] = None,
    prune_rates: Optional[Dict[int, float]] = None,
    cost_model=None,
    disk_budget_bytes: Optional[int] = 0,
) -> MaterializationPlan:
    """Choose which stages fit a byte budget (compressed, column-projected
    sizes from the store's stats pass).

    Greedy in stage order — stages are ordered output-first, so earlier
    stages are the root of the param-binding chain: keeping a later stage
    without its binding ancestors buys nothing.  ``budget_bytes=None`` keeps
    everything (the current precise behaviour); ``0`` drops everything (the
    pure Algorithm-3 path).  ``unavailable`` marks stages the store cannot
    serve at all (e.g. evicted before a spill) — they are dropped regardless
    of budget, along with everything depending on them.

    ``disk_budget_bytes`` opens the out-of-core second tier: a stage that
    doesn't fit the RAM budget is *demoted* to disk (recorded in ``disk``)
    instead of dropped, as long as it fits the cumulative disk budget
    (``None`` = unlimited disk, ``0`` = tier disabled).  Disk stages stay
    fully available to the query phase — memmap-backed, scanned in situ,
    answers precise and bit-identical — so they never degrade dependents;
    only stages fitting *neither* budget fall to the superset path.

    ``partition_sizes`` (per-partition encoded bytes) makes the budget
    accounting partition-granular — a stage's footprint is the sum of its
    chunks — and ``prune_rates`` (estimated zone-map prune fraction per
    stage) feeds the prune-aware ``scan_cost`` recorded on the plan: a
    heavily-prunable stage is cheap to *query* even when it is large to
    *keep*.

    ``cost_model`` (a :class:`repro_torch.core.cost.CostModel`) refines the
    per-stage scan-cost estimate: bytes surviving the prune are charged at
    the model's pruned-gather/serial slope ratio (learned online), capped at
    the full-scan bytes, instead of the bare ``kept = size * (1 - prune)``
    heuristic."""
    unavailable = unavailable or set()
    partition_sizes = partition_sizes or {}
    prune_rates = prune_rates or {}

    def stage_bytes(nid: int) -> int:
        parts = partition_sizes.get(nid)
        if parts:
            return int(sum(parts))
        return int(sizes.get(nid, 0))

    def cost_of(nid: int) -> float:
        nb = stage_bytes(nid)
        rate = float(prune_rates.get(nid, 0.0))
        if cost_model is not None:
            return cost_model.stage_scan_cost(nb, rate)
        return nb * (1.0 - rate)

    partitions = {nid: len(p) for nid, p in partition_sizes.items()}
    scan_cost = {
        nid: cost_of(nid)
        for nid in {s.node_id for s in lp.stages} & set(sizes)
    }
    if budget_bytes is None and not unavailable:
        return MaterializationPlan(None, [s.node_id for s in lp.stages], set(),
                                   dict(sizes), partitions, scan_cost,
                                   disk_budget_bytes=disk_budget_bytes)
    budget = float("inf") if budget_bytes is None else budget_bytes
    disk_budget = (float("inf") if disk_budget_bytes is None
                   else disk_budget_bytes)
    deps = stage_param_deps(lp)
    kept: List[int] = []
    disk: List[int] = []
    dropped: Set[int] = set()
    total = 0
    disk_total = 0
    for st in lp.stages:
        sz = stage_bytes(st.node_id)
        if st.node_id in unavailable or deps[st.node_id] & dropped:
            dropped.add(st.node_id)
            continue
        if total + sz <= budget:
            kept.append(st.node_id)
            total += sz
        elif disk_total + sz <= disk_budget:
            disk.append(st.node_id)
            disk_total += sz
        else:
            dropped.add(st.node_id)
    return MaterializationPlan(budget_bytes, kept, dropped, dict(sizes),
                               partitions, scan_cost, disk=disk,
                               disk_budget_bytes=disk_budget_bytes)


class _FailureAt(Exception):
    def __init__(self, node: O.Node, path: List[O.Node]):
        self.node = node
        self.path = path  # root ... node


class LineageInference:
    """Runs Algorithm 1 (+ Algorithm 2 placement optimization)."""

    def __init__(
        self,
        plan: O.Node,
        catalog_schemas: Dict[str, List[str]],
        stats: Optional[Dict[int, NodeStats]] = None,
        optimize_placement: bool = True,
        precise_minmax: bool = False,
    ):
        self.plan = plan
        self.pd = Pushdown(plan, catalog_schemas, precise_minmax=precise_minmax)
        self.stats = stats or {}
        self.optimize_placement = optimize_placement

    # ------------------------------------------------------------------ #
    def infer(self) -> LineagePlan:
        out_schema = self.pd.schema_of(self.plan)
        forced: Set[int] = set()
        while True:
            try:
                stages, source_preds, out_params = self._descend_all(forced)
                break
            except _FailureAt as f:
                j = self._choose_placement(f.node, f.path, forced)
                if j in forced:
                    raise RuntimeError(
                        f"lineage inference cannot make progress at node {j}: "
                        f"row-selection pushdown is imprecise even after "
                        f"materializing — operator rule bug"
                    )
                forced.add(j)
        lp = LineagePlan(self.plan, out_params, stages, source_preds,
                         superset_scope=self._superset_scope)
        self._project_columns(lp)
        return lp

    # ------------------------------------------------------------------ #
    def _descend_all(self, forced: Set[int]):
        Frow, pmap = row_selection_for(self.pd.schema_of(self.plan), stage="out")
        out_params = {p: c for p, c in pmap.items()}
        stages: List[Stage] = []
        source_preds: List[SourcePred] = []
        self._superset_scope = {}

        def rec(node: O.Node, F: Expr, guards: List[str], path: List[O.Node]):
            if isinstance(node, O.Source):
                source_preds.append(SourcePred(node.id, node.table, F, list(guards)))
                return
            staged_here = False
            F_in, guards_in = F, list(guards)
            if node.id in forced:
                Frow_i, pmap_i = row_selection_for(self.pd.schema_of(node), stage=str(node.id))
                # §5 pruning: push the FULL row-selection once to learn which
                # pins precision actually requires, then rebuild F^row over
                # (required params) ∪ (columns the downstream predicate F
                # uses); the rest of the pins are redundant under set
                # semantics and only bloat intermediates + source predicates.
                required = self._collect_required(node, Frow_i)
                downstream = cols_of(F)
                keep_params = {
                    p for p, c in pmap_i.items() if p in required or c in downstream
                }
                atoms = [
                    BinOp("==", Col(c), Param(p, origin=(str(node.id), c)))
                    for p, c in pmap_i.items()
                    if p in keep_params
                ]
                from .expr import land as _land

                if atoms:
                    Frow_p = _land(*atoms)
                    pmap_p = {p: c for p, c in pmap_i.items() if p in keep_params}
                else:  # degenerate: keep the full row selection
                    Frow_p, pmap_p = Frow_i, pmap_i
                # safety: pruned row selection must still push precisely
                if not self._precise_below(node, Frow_p):
                    Frow_p, pmap_p = Frow_i, pmap_i
                stages.append(
                    Stage(node.id, run_pred=F, params_out=dict(pmap_p),
                          guards=list(guards))
                )
                F = Frow_p
                guards = []
                staged_here = True
            push = self.pd.push_node(node, F)
            if push.superset:
                # SUPERSET marker (opaque UDF): mandatory materialization
                # boundary.  The saved output certifies the answer — above it
                # everything stays precise; below it the rule's whole-input
                # push (TRUE) is the paper's well-defined lineage.  The stage
                # binds no params (nothing crosses an opaque boundary); it
                # exists so the query phase can verify the intermediate is
                # available, and its absence (budget drop / missing spill)
                # flags every table below as a superset.  A forced node
                # already staged itself above with the same run predicate.
                if not staged_here:
                    stages.append(Stage(node.id, run_pred=F_in, params_out={},
                                        guards=guards_in))
                self._superset_scope[node.id] = sorted(
                    {s.table for s in O.sources(node)}
                )
                for child in node.children:
                    rec(child, push.gs.get(child.id, TRUE), [], path + [node])
                return
            if not push.precise:
                raise _FailureAt(node, path + [node])
            for child in node.children:
                g = push.gs.get(child.id, TRUE)
                child_guards = guards + push.guards.get(child.id, [])
                rec(child, g, child_guards, path + [node])

        rec(self.plan, Frow, [], [])
        return stages, source_preds, out_params

    # ------------------------------------------------------------------ #
    def _collect_required(self, node: O.Node, F: Expr) -> Set[str]:
        """Params whose pins the subtree's operators need for precision."""
        out: Set[str] = set()

        def rec(n: O.Node, f: Expr):
            if isinstance(n, O.Source):
                return
            push = self.pd.push_node(n, f, relaxed=True)
            out.update(push.required)
            for c in n.children:
                rec(c, push.gs.get(c.id, TRUE))

        rec(node, F)
        return out

    def _precise_below(self, node: O.Node, F: Expr) -> bool:
        def rec(n: O.Node, f: Expr) -> bool:
            if isinstance(n, O.Source):
                return True
            push = self.pd.push_node(n, f)
            if not push.precise:
                return False
            return all(rec(c, push.gs.get(c.id, TRUE)) for c in n.children)

        return rec(node, F)

    # ------------------------------------------------------------------ #
    def _subtree_ok(self, j: O.Node, forced: Set[int]) -> bool:
        """Does a row-selection predicate at ``j`` push precisely through the
        whole subtree below it (with existing forced stages honored)?"""
        Frow_j, _ = row_selection_for(self.pd.schema_of(j), stage=f"sim{j.id}")

        def rec(node: O.Node, F: Expr) -> bool:
            if isinstance(node, O.Source):
                return True
            if node.id in forced and node.id != j.id:
                F, _ = row_selection_for(self.pd.schema_of(node), stage=f"sim{node.id}")
            push = self.pd.push_node(node, F)
            if not push.precise:
                return False
            return all(rec(c, push.gs.get(c.id, TRUE)) for c in node.children)

        push = self.pd.push_node(j, Frow_j)
        if not push.precise:
            return False
        return all(rec(c, push.gs.get(c.id, TRUE)) for c in j.children)

    def _est_size(self, node: O.Node) -> float:
        st = self.stats.get(node.id)
        if st is None:
            return float("inf")
        return float(st.nbytes)

    def _choose_placement(self, node: O.Node, path: List[O.Node], forced: Set[int]) -> int:
        """Algorithm 2 (choice part): candidates are the failure node and its
        main-path ancestors; walk outward while viable, pick the smallest."""
        candidates = [node]
        if self.optimize_placement:
            # ancestors from nearest to root, but only along the main dataflow
            for anc in reversed(path[:-1]):
                if anc.main_child is None:
                    break
                candidates.append(anc)
        best = node.id
        best_size = self._est_size(node)
        for cand in candidates[1:]:
            if cand.id in forced:
                break
            if not self._subtree_ok(cand, forced | {cand.id}):
                break  # paper Algorithm 2 line 10-11: stop at first failure
            sz = self._est_size(cand)
            if sz < best_size:
                best, best_size = cand.id, sz
        return best

    # ------------------------------------------------------------------ #
    def _project_columns(self, lp: LineagePlan) -> None:
        """Algorithm 2 (column projection): keep only (a) columns referenced
        by the stage's own run-predicate and (b) columns bound to params that
        actually survive into downstream predicates."""
        used_params: Set[str] = set()
        for sp in lp.source_preds:
            used_params |= params_of(sp.pred)
        for s in lp.stages:
            used_params |= params_of(s.run_pred)
        for s in lp.stages:
            keep = set(cols_of(s.run_pred))
            for p, c in s.params_out.items():
                if p in used_params:
                    keep.add(c)
            node_schema = set(self.pd.schemas[s.node_id])
            s.keep_cols = sorted(keep & node_schema)
