"""Verification of equivalent pushdown — paper §4.2, Figure 2.

Reimplements the paper's symbolic row-exist check without an SMT solver
(Z3 is unavailable offline; our predicate language is closed, so equivalence
is decidable by canonicalization):

1. build single-row symbolic tables for every input of the operator — each
   input column ``c`` of child ``k`` becomes a distinct symbolic cell
   ``@k.c``;
2. push ``F`` to get ``G`` and a fresh full row-selection ``F^row`` to get
   ``G^row``;
3. substitute every parameter by its *defining output cell expression*
   (``F ≡ F^row`` ties each param to the output row's cell; output cells map
   to input cells through the operator's single-row semantics);
4. per input table, both predicates are conjunctions of atoms over symbolic
   cells: drop reflexive equalities (``x == x``), canonicalize, and compare
   atom sets.  Unequal sets ⇒ pushing ``F`` is *not* equivalent to pushing a
   row-selection predicate ⇒ the operator's output must be materialized.

For grouping-type operators a single symbolic row cannot expose key-pinning
violations (the paper uses two-row tables there); those operators are decided
by the structural rules in ``pushdown.py`` and differentially tested against
the eager oracle.  This module is used to cross-validate the join-family
verdicts, which is where Figure 2's reasoning is non-trivial.
"""

from __future__ import annotations

from typing import Dict, Optional

from . import ops as O
from .expr import (
    TRUE,
    BinOp,
    Col,
    Expr,
    IsIn,
    Param,
    canonical_atoms,
    conjuncts,
    pinned_cols,
    row_selection_for,
    substitute_cols,
)
from .pushdown import Pushdown

JOIN_FAMILY = (O.InnerJoin, O.LeftOuterJoin, O.SemiJoin, O.AntiJoin, O.FilterScalarSub)


def _sym(child_id: int, col: str) -> Col:
    return Col(f"@{child_id}.{col}")


def _output_cells(pd: Pushdown, n: O.Node) -> Dict[str, Expr]:
    """Map each output column of ``n`` to its defining symbolic input cell
    (single-row semantics)."""
    if isinstance(n, (O.InnerJoin, O.LeftOuterJoin)):
        lcols = pd.schema_of(n.left)
        rcols = pd.schema_of(n.right)
        out: Dict[str, Expr] = {}
        for c in lcols:
            out[c] = _sym(n.left.id, c)
        for c in rcols:
            if c not in out:
                out[c] = _sym(n.right.id, c)
        return out
    if isinstance(n, (O.SemiJoin, O.AntiJoin)):
        return {c: _sym(n.outer.id, c) for c in pd.schema_of(n.outer)}
    if isinstance(n, O.FilterScalarSub):
        return {c: _sym(n.child.id, c) for c in pd.schema_of(n.child)}
    raise TypeError(f"symbolic output cells: unsupported {type(n)}")


def _bind_params_to_cells(pred: Expr, param_cols: Dict[str, str], cells: Dict[str, Expr]) -> Expr:
    """Replace each Param whose defining output column is known by the
    symbolic cell expression of that column."""

    def walk(x: Expr) -> Expr:
        if isinstance(x, Param):
            col = param_cols.get(x.name)
            if col is not None and col in cells:
                return cells[col]
            return x
        if isinstance(x, BinOp):
            return BinOp(x.op, walk(x.left), walk(x.right))
        if isinstance(x, IsIn):
            vals = walk(x.values) if isinstance(x.values, Expr) else x.values
            return IsIn(walk(x.operand), vals)
        return x

    return walk(pred)


def _normalize(pred: Expr) -> frozenset:
    """Canonical atom set with reflexive equalities removed."""
    atoms = []
    for a in conjuncts(pred):
        if isinstance(a, BinOp) and a.op == "==" and a.left == a.right:
            continue  # x == x  ->  TRUE
        atoms.append(a)
    if not atoms:
        return frozenset()
    from .expr import land

    return canonical_atoms(land(*atoms))


def symbolic_check(pd: Pushdown, n: O.Node, F: Expr) -> Optional[bool]:
    """Return True/False for 'pushing F is equivalent to pushing a
    row-selection predicate' on join-family operators; None when the operator
    family is out of scope for the single-row check."""
    if not isinstance(n, JOIN_FAMILY):
        return None

    cells = _output_cells(pd, n)

    G = pd.push_node(n, F)
    out_schema = pd.schema_of(n)
    Frow, pmap = row_selection_for(out_schema, stage=f"verify{n.id}")
    Grow = pd.push_node(n, Frow)

    # params of F: an output row satisfying F ties each pinned column's param
    # to the output cell; params of Frow tie to their column's cell by
    # construction.
    f_param_cols: Dict[str, str] = {}
    for col, rhs in pinned_cols(F).items():
        if isinstance(rhs, Param):
            f_param_cols[rhs.name] = col
    frow_param_cols = {p: c for p, c in pmap.items()}

    bound_g = {}
    bound_grow = {}
    for child in n.children:
        g = G.gs.get(child.id, TRUE)
        grow = Grow.gs.get(child.id, TRUE)
        g_b = _bind_params_to_cells(
            _to_cells(g, child.id, pd), f_param_cols, cells
        )
        grow_b = _bind_params_to_cells(
            _to_cells(grow, child.id, pd), frow_param_cols, cells
        )
        # also bind any F-params appearing inside grow (via key transfer)
        grow_b = _bind_params_to_cells(grow_b, f_param_cols, cells)
        bound_g[child.id] = g_b
        bound_grow[child.id] = grow_b

    # Join-key congruence: if BOTH sides' predicates-under-test pin their key
    # columns to the same value, the key cells are equivalent given that the
    # output row exists (the extra joinability atom in G^row collapses — the
    # Q3 case).  With an unpinned side, no congruence is assumed — the Q4
    # semi-join case stays inequivalent, exactly as in paper Figure 2.
    subst: Dict[str, Expr] = {}
    pairs = []
    if isinstance(n, (O.InnerJoin, O.LeftOuterJoin)):
        pairs = [(n.left.id, lk, n.right.id, rk) for lk, rk in n.on]
    elif isinstance(n, (O.SemiJoin, O.AntiJoin)):
        pairs = [(n.outer.id, ok, n.inner.id, ik) for ok, ik in n.on]
    elif isinstance(n, O.FilterScalarSub):
        pairs = [(n.child.id, oc, n.inner.id, ic) for oc, ic in n.correlate]
    for lcid, lk, rcid, rk in pairs:
        lcell, rcell = f"@{lcid}.{lk}", f"@{rcid}.{rk}"
        val_l = _cell_pin(bound_g.get(lcid, TRUE), lcell)
        val_r = _cell_pin(bound_g.get(rcid, TRUE), rcell)
        if val_l is not None and val_r is not None and val_l == val_r:
            subst[rcell] = Col(lcell)

    for child in n.children:
        g_b = substitute_cols(bound_g[child.id], subst)
        grow_b = substitute_cols(bound_grow[child.id], subst)
        if _normalize(g_b) != _normalize(grow_b):
            return False
    return True


def _cell_pin(pred: Expr, cell: str) -> Optional[Expr]:
    """The value an equality atom pins ``cell`` to (any expression rhs)."""
    for a in conjuncts(pred):
        if isinstance(a, BinOp) and a.op == "==":
            if isinstance(a.left, Col) and a.left.name == cell:
                return a.right
            if isinstance(a.right, Col) and a.right.name == cell:
                return a.left
    return None


def _to_cells(pred: Expr, child_id: int, pd: Pushdown) -> Expr:
    """Rename plain column references in a pushed predicate to the child's
    symbolic cells."""
    mapping = {}
    for n in O.walk(pd.plan):
        if n.id == child_id:
            for c in pd.schema_of(n):
                mapping[c] = _sym(child_id, c)
    return substitute_cols(pred, mapping)
