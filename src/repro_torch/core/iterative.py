"""Algorithm 3 — lineage without saving intermediate results (paper §6).

Four phases:

1. *Pushdown allowing supersets*: the relaxed pushdown drops unpushable atoms
   (semi-join inners receive ``True`` when the key is not pinned, etc.),
   reaching every source with a sound superset predicate ``G^Ti``
   (Lemma 3.2).
2. *Predicate pushup*: every source table gets a parameterized row-value
   predicate ``col ∈ V^{Ti}_col``; pushing these up through the plan merges
   V-sets at join-family operators (the outer key inherits the inner key's
   V-set, etc. — paper §6.1/§6.3).
3. *Pushdown again*: the conjunction ``F ∧ F↑`` is pushed down; equi-key
   transfer now exchanges V-set membership atoms *across* tables, producing
   ``G^Ti↓`` that filters each table by the other tables' lineage values.
4. *Iterative refinement*: concretize, initialize V-sets by running ``G^Ti``,
   then re-run ``G^Ti↓`` updating V-sets until fixpoint.  Iterations are
   bounded by the longest join chain (paper §6.2).

The fixpoint scans are pure predicate evaluations over columnar blocks — a
PredTrace runs them through its ScanEngine, whose torch backend launches the
fused ``pred_filter`` kernel.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from . import ops as O
from .expr import (
    FALSE,
    TRUE,
    Col,
    Expr,
    IsIn,
    ParamSet,
    cols_of,
    conjuncts,
    eval_np,
    land,
    lor,
    paramsets_of,
    row_selection_for,
)
from .pushdown import Pushdown
from .table import Table


@dataclass
class IterativePlan:
    plan: O.Node
    out_params: Dict[str, str]  # param -> output column
    g1: Dict[int, Tuple[str, Expr]]  # source node id -> (table, phase-1 predicate)
    g3: Dict[int, Tuple[str, Expr]]  # source node id -> (table, phase-3 predicate)
    vsets: Dict[str, Tuple[int, str]]  # ParamSet name -> (source node id, column)
    # branch-coupled V-sets (beyond-paper FP reduction for mixed-side OR
    # predicates, see _branch_couple): name -> (source id, key col, branch pred)
    branch_vsets: Dict[str, Tuple[int, str, Expr]] = field(default_factory=dict)


class IterativeInference:
    def __init__(self, plan: O.Node, catalog_schemas: Dict[str, List[str]]):
        self.plan = plan
        self.pd = Pushdown(plan, catalog_schemas)

    # ------------------------------------------------------------------ #
    def infer(self) -> IterativePlan:
        Frow, pmap = row_selection_for(self.pd.schema_of(self.plan), stage="out")
        out_params = dict(pmap)

        # ---- phase 1: relaxed pushdown --------------------------------- #
        g1: Dict[int, Tuple[str, Expr]] = {}

        def down1(node: O.Node, F: Expr):
            if isinstance(node, O.Source):
                # a source reached via several paths (shared-subtree DAGs:
                # Union parts, Intersect sides, self-joins) contributes rows
                # through ANY of them, so per-path predicates OR-combine.
                # AND-combining was unsound: a Union part's rows need not
                # satisfy the sibling part's predicate (fuzzer-found,
                # tests/corpus/union_intersect_count.json).
                prev = g1.get(node.id)
                g1[node.id] = (node.table, F if prev is None else lor(prev[1], F))
                return
            push = self.pd.push_node(node, F, relaxed=True)
            for c in node.children:
                down1(c, push.gs.get(c.id, TRUE))

        down1(self.plan, Frow)

        # ---- phase 2: pushup ------------------------------------------- #
        vsets: Dict[str, Tuple[int, str]] = {}
        up_cache: Dict[int, Expr] = {}

        def vset(node: O.Source, col: str) -> ParamSet:
            name = f"V_{node.id}_{col}"
            vsets[name] = (node.id, col)
            return ParamSet(name, table=node.table, column=col)

        def up(node: O.Node) -> Expr:
            if node.id in up_cache:
                return up_cache[node.id]
            # §6.1 transformations come from the pushdown-rule registry, so
            # third-party operators supply pushup behaviour the same way
            # they supply pushdown rules
            r = self.pd.push_up(node, up, vset)
            up_cache[node.id] = r
            return r

        up(self.plan)

        # ---- phase 3: pushdown again ------------------------------------ #
        g3: Dict[int, Tuple[str, Expr]] = {}
        branch_vsets: Dict[str, Tuple[int, str, Expr]] = {}

        def source_chain(node: O.Node):
            """Resolve a node to (Source, conjunction of filters) when it is a
            simple Filter*/Sort* chain over a Source; else None."""
            preds = []
            cur = node
            while True:
                if isinstance(cur, O.Source):
                    return cur, land(*preds)
                if isinstance(cur, O.Filter):
                    preds.append(cur.pred)
                    cur = cur.child
                elif isinstance(cur, O.Sort) and cur.limit is None:
                    cur = cur.child
                else:
                    return None

        def branch_couple(n: O.Node, atom: Expr) -> Dict[int, Expr]:
            """For a dropped mixed-side OR atom at an equi-join whose children
            are source chains, emit per-side predicates where each OR branch
            is coupled to the other side via a branch V-set on the join key:
                left:  OR_i ( branch_l_i  AND  lk IN V{right, rk, branch_r_i} )
            Sound (implied by the atom + join) and converges to 0 FP for
            Q19-style conditions."""
            from .expr import disjuncts

            if not isinstance(n, O.InnerJoin) or not n.on:
                return {}
            lres, rres = source_chain(n.left), source_chain(n.right)
            if lres is None or rres is None:
                return {}
            (lsrc, _), (rsrc, _) = lres, rres
            lcols = set(self.pd.schema_of(n.left))
            rcols = set(self.pd.schema_of(n.right))
            branches = disjuncts(atom)
            if len(branches) < 2:
                return {}
            lk, rk = n.on[0]
            l_out, r_out = [], []
            for i, b in enumerate(branches):
                bl = land(*[c for c in conjuncts(b) if cols_of(c) <= lcols])
                br = land(*[c for c in conjuncts(b) if cols_of(c) <= rcols])
                leftover = [
                    c for c in conjuncts(b)
                    if not (cols_of(c) <= lcols) and not (cols_of(c) <= rcols)
                ]
                if leftover:
                    return {}
                r_name = f"Vbr_{n.id}_{atom.__hash__() & 0xFFFF}_{i}_r"
                l_name = f"Vbr_{n.id}_{atom.__hash__() & 0xFFFF}_{i}_l"
                branch_vsets[r_name] = (rsrc.id, rk, br)
                branch_vsets[l_name] = (lsrc.id, lk, bl)
                l_out.append(land(bl, IsIn(Col(lk), ParamSet(r_name))))
                r_out.append(land(br, IsIn(Col(rk), ParamSet(l_name))))
            return {n.left.id: lor(*l_out), n.right.id: lor(*r_out)}

        def down3(node: O.Node, F: Expr):
            if isinstance(node, O.Source):
                # drop own-table membership atoms: refinement already
                # intersects with the running mask, so they are redundant
                atoms = [
                    a
                    for a in conjuncts(F)
                    if not (
                        isinstance(a, IsIn)
                        and isinstance(a.values, ParamSet)
                        and vsets.get(a.values.name, (None,))[0] == node.id
                    )
                ]
                combined = land(*atoms)
                # OR across arrival paths, matching down1 (superset contract)
                prev = g3.get(node.id)
                g3[node.id] = (node.table, combined if prev is None else lor(prev[1], combined))
                return
            D = land(F, up_cache.get(node.id, TRUE))
            push = self.pd.push_node(node, D, relaxed=True)
            extra: Dict[int, Expr] = {}
            for a in push.dropped:
                for cid, pred in branch_couple(node, a).items():
                    extra[cid] = land(extra.get(cid, TRUE), pred)
            for c in node.children:
                down3(c, land(push.gs.get(c.id, TRUE), extra.get(c.id, TRUE)))

        down3(self.plan, Frow)

        return IterativePlan(self.plan, out_params, g1, g3, vsets, branch_vsets)

# --------------------------------------------------------------------------- #
# phase 4: concretization + fixpoint refinement
# --------------------------------------------------------------------------- #


@dataclass
class RefineResult:
    masks: Dict[int, np.ndarray]  # source node id -> boolean mask
    lineage: Dict[str, np.ndarray]  # table -> row ids (union over occurrences)
    iterations: int = 0
    naive_masks: Dict[int, np.ndarray] = field(default_factory=dict)


def refine(
    ip: IterativePlan,
    catalog: Dict[str, Table],
    binding: Dict[str, object],
    max_iters: int = 32,
    scan: Optional[Callable[[Expr, Table, Dict[str, object]], np.ndarray]] = None,
) -> RefineResult:
    """Phase 4.  ``binding`` maps the output-row params to values.  ``scan``
    lets callers swap the predicate-scan backend (the process-wide
    ``default_engine()`` on the CUDA device by default; PredTrace plugs in
    its own engine's scan)."""
    if scan is None:
        from .scan import default_engine

        scan = default_engine().scan

    # which V-sets are actually referenced by any phase-3 predicate
    used: Set[str] = set()
    for _, pred in ip.g3.values():
        used |= paramsets_of(pred)

    vv: Dict[str, object] = dict(binding)
    masks: Dict[int, np.ndarray] = {}
    naive: Dict[int, np.ndarray] = {}

    # initialize from phase-1 predicates
    for sid, (tab, pred) in ip.g1.items():
        t = catalog[tab]
        m = scan(pred, t, vv)
        masks[sid] = m
        naive[sid] = m.copy()
    _update_vsets(ip, catalog, masks, vv, used, scan)

    iters = 0
    for _ in range(max_iters):
        iters += 1
        changed = False
        for sid, (tab, pred) in ip.g3.items():
            t = catalog[tab]
            m = scan(pred, t, vv)
            m = m & masks[sid]  # refinement can only shrink
            if m.sum() != masks[sid].sum():
                changed = True
            masks[sid] = m
        _update_vsets(ip, catalog, masks, vv, used, scan)
        if not changed:
            break

    lineage: Dict[str, np.ndarray] = {}
    for sid, (tab, _) in ip.g1.items():
        rids = catalog[tab].rids()[masks[sid]]
        lineage[tab] = (
            np.union1d(lineage[tab], rids) if tab in lineage else np.unique(rids)
        )
    return RefineResult(masks, lineage, iters, naive)


def _update_vsets(ip, catalog, masks, vv, used: Set[str], scan=None):
    for name, (sid, col) in ip.vsets.items():
        if name not in used:
            continue
        tab = ip.g1[sid][0] if sid in ip.g1 else None
        if tab is None:
            continue
        t = catalog[tab]
        vv[name] = np.unique(t.cols[col][masks[sid]])
    for name, (sid, col, pred) in getattr(ip, "branch_vsets", {}).items():
        if name not in used:
            continue
        tab = ip.g1[sid][0] if sid in ip.g1 else None
        if tab is None:
            continue
        t = catalog[tab]
        if scan is not None:
            bm = scan(pred, t, vv)
        else:
            bm = np.asarray(eval_np(pred, t.cols, vv, n=t.nrows), dtype=bool)
        m = masks[sid] & bm
        vv[name] = np.unique(t.cols[col][m])
