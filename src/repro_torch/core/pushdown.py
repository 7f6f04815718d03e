"""Predicate pushdown rules for every PredTrace operator (paper Table 2 + §4).

``push_node`` pushes a predicate ``F`` (on a node's *output*) one operator down,
returning per-child predicates ``G`` plus a **precision verdict**: does pushing
``F`` select the *precise* lineage (equivalent to pushing a row-selection
predicate, paper §4.2)?

Rules live in a :class:`PushdownRuleRegistry` — one rule per (operator type,
lineage-annotation kind) — instead of a hard-coded isinstance chain, so
third-party operators (and UDF annotation classes) register pushdown *and*
pushup behaviour without editing core.  A rule returns one of three verdicts
through its :class:`Push`:

* **precise push**   — ``precise=True``: pushing ``F`` computes exact lineage;
* **relaxed push**   — ``precise=False`` with ``dropped`` atoms: a sound
  superset (Lemma 3.2), used by Algorithm 3 and by Algorithm 1 to decide
  materialization;
* **SUPERSET marker** — ``superset=True``: the operator is opaque; lineage
  through it is the *whole input* by definition, and Algorithm 1 must treat
  the node as a mandatory materialization boundary (saving the intermediate
  restores precision above it, paper §6).

The predicate language is closed (see ``expr.py``), which makes the paper's
symbolic-verification question decidable by structural rules; the Figure-2
style symbolic row-exist check in ``verify.py`` cross-validates these verdicts
on join-type operators, and the hypothesis test-suite differentially checks
both against the eager oracle.  UDF bodies are *not* in the closed language —
their rules rely only on the declared :class:`~repro_torch.core.expr.LineageAnnotation`
(plus re-executability for ``filter_like``, whose rule conjoins the body as a
:class:`~repro_torch.core.expr.UDFExpr` atom).

Key transfer: equality / membership pins on one side of an equi-join key are
mirrored to the other side — this is what exchanges V-sets between tables in
Algorithm 3 (paper §6.3) and what makes row-selection pushdowns through joins
precise (paper §5, Q3 example).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from . import ops as O
from .expr import (
    FALSE,
    TRUE,
    BinOp,
    Col,
    Expr,
    IsIn,
    Lit,
    Param,
    ParamSet,
    cols_of,
    conjuncts,
    disjuncts,
    land,
    lor,
    substitute_cols,
)


def _or_split(atom: Expr, side_cols: Sequence[Set[str]]) -> List[Optional[Expr]]:
    """Relax a mixed-side disjunction-of-conjunctions into per-side
    disjunctions of the side-local conjunct projections (sound: implied by
    the original atom).  This is the relaxation a search-based pushdown
    module (MagicPush) finds for Q19-style OR conditions."""
    branches = disjuncts(atom)
    if len(branches) < 2:
        return [None] * len(side_cols)
    outs: List[Optional[Expr]] = []
    for sc in side_cols:
        side_branches = []
        ok = True
        for b in branches:
            parts = [c for c in conjuncts(b) if cols_of(c) <= sc]
            if not parts:
                ok = False
                break
            side_branches.append(land(*parts))
        outs.append(lor(*side_branches) if ok else None)
    return outs


@dataclass
class Push:
    """Result of pushing F through one operator."""

    gs: Dict[int, Expr]  # child node id -> predicate on that child's output
    precise: bool
    dropped: List[Expr] = field(default_factory=list)  # atoms dropped (superset)
    # params whose pins this operator NEEDED for a precise pushdown (join /
    # group keys, correlates, safe-drop justifications) — drives the paper's
    # §5 row-selection-predicate pruning / column projection
    required: Set[str] = field(default_factory=set)
    # child id -> param names that must bind non-NULL for the predicate to
    # apply (left-outer-join right side; see plan concretization)
    guards: Dict[int, List[str]] = field(default_factory=dict)
    # SUPERSET marker: the operator is opaque — the pushed (whole-input)
    # predicate is the paper's well-defined superset and Algorithm 1 must
    # materialize this node's output unconditionally
    superset: bool = False


# --------------------------------------------------------------------------- #
# atom helpers
# --------------------------------------------------------------------------- #


def pins_of(F: Expr) -> Dict[str, Expr]:
    """col -> rhs for equality pins (``col == Param/Lit``) and membership pins
    (``col IN set`` / ``col IN ParamSet``)."""
    out: Dict[str, Expr] = {}
    for a in conjuncts(F):
        if isinstance(a, BinOp) and a.op == "==":
            l, r = a.left, a.right
            if isinstance(l, Col) and isinstance(r, (Param, Lit)):
                out.setdefault(l.name, r)
            elif isinstance(r, Col) and isinstance(l, (Param, Lit)):
                out.setdefault(r.name, l)
        elif isinstance(a, IsIn) and isinstance(a.operand, Col):
            out.setdefault(a.operand.name, a)  # marker: membership pin
    return out


def _pin_param(pin) -> Set[str]:
    if isinstance(pin, Param):
        return {pin.name}
    if isinstance(pin, IsIn):
        from .expr import params_of as _po
        return _po(pin)
    return set()


def _pin_atom(col: str, pin: Expr) -> Expr:
    """Re-materialize a pin as an atom on (possibly another) column ``col``."""
    if isinstance(pin, IsIn):
        return IsIn(Col(col), pin.values)
    return BinOp("==", Col(col), pin)


def _split_atoms(F: Expr, side_cols: Sequence[Set[str]]) -> Tuple[List[List[Expr]], List[Expr]]:
    """Partition conjuncts by which single side's schema covers them.
    Returns (per-side atom lists, unassignable atoms)."""
    per = [[] for _ in side_cols]
    bad: List[Expr] = []
    for a in conjuncts(F):
        cols = cols_of(a)
        placed = False
        for i, sc in enumerate(side_cols):
            if cols <= sc:
                per[i].append(a)
                placed = True
                break
        if not placed:
            bad.append(a)
    return per, bad


def _memberships(pred: Expr) -> Dict[str, ParamSet]:
    """col -> ParamSet for V-set membership atoms in a conjunction."""
    out: Dict[str, ParamSet] = {}
    for a in conjuncts(pred):
        if isinstance(a, IsIn) and isinstance(a.operand, Col) and isinstance(a.values, ParamSet):
            out.setdefault(a.operand.name, a.values)
    return out


# --------------------------------------------------------------------------- #
# rule registry
# --------------------------------------------------------------------------- #

# pushdown rule: (pd, node, F, relaxed) -> Push
RuleFn = Callable[["Pushdown", O.Node, Expr, bool], Push]
# pushup rule (§6.1 transformation): (pd, node, up, vset) -> Expr, where
# ``up(child)`` recurses and ``vset(source_node, col)`` mints the source's
# row-value set variable
PushupFn = Callable[["Pushdown", O.Node, Callable, Callable], Expr]


class PushdownRuleRegistry:
    """Pluggable per-operator pushdown/pushup rules.

    Rules are keyed by ``(operator type, annotation kind)`` — the annotation
    kind is read from the node's ``annotation.kind`` when present, so one
    operator class can carry different rules per lineage-annotation class.
    Lookup walks the node type's MRO (a subclass inherits its base's rules
    unless it registers its own), checking the node's annotation kind before
    the kind-agnostic entry at each class, then falls back to the parent
    registry.  Third-party operators extend the engine with::

        registry = PushdownRuleRegistry(parent=DEFAULT_REGISTRY)
        registry.register(MyNode, my_rule, pushup=my_pushup)
        Pushdown(plan, schemas, registry=registry)

    or register into :data:`DEFAULT_REGISTRY` directly for process-wide ops.
    """

    def __init__(self, parent: Optional["PushdownRuleRegistry"] = None):
        self._down: Dict[Tuple[type, Optional[str]], RuleFn] = {}
        self._up: Dict[Tuple[type, Optional[str]], PushupFn] = {}
        self._parent = parent

    # ------------------------------------------------------------------ #
    def register(self, node_type: type, rule: Optional[RuleFn] = None, *,
                 annotation: Optional[str] = None,
                 pushup: Optional[PushupFn] = None):
        """Register ``rule`` (and/or ``pushup``) for ``node_type``, optionally
        specialized to one annotation kind.  Returns the rule so it can be
        used as a decorator: ``@registry.register(MyNode)``."""

        def _install(fn):
            if fn is not None:
                self._down[(node_type, annotation)] = fn
            if pushup is not None:
                self._up[(node_type, annotation)] = pushup
            return fn

        if rule is None and pushup is None:
            return _install  # decorator form
        return _install(rule)

    # ------------------------------------------------------------------ #
    @staticmethod
    def _annotation_kind(node) -> Optional[str]:
        ann = getattr(node, "annotation", None)
        return getattr(ann, "kind", None)

    def _lookup(self, which: str, node):
        kind = self._annotation_kind(node)
        reg = self
        while reg is not None:
            table = reg._down if which == "down" else reg._up
            for klass in type(node).__mro__:
                if kind is not None and (klass, kind) in table:
                    return table[(klass, kind)]
                if (klass, None) in table:
                    return table[(klass, None)]
            reg = reg._parent
        return None

    def rule_for(self, node: O.Node) -> RuleFn:
        """Pushdown rule for ``node`` (most-specific registered match).

        Args:
            node: pipeline plan operator.
        Returns:
            RuleFn: ``(node, pred, ctx) -> Push`` transfer function.
        Raises:
            TypeError: no rule registered for the node's type/annotation.
        """
        fn = self._lookup("down", node)
        if fn is None:
            raise TypeError(
                f"no pushdown rule registered for {type(node).__name__} "
                f"(annotation={self._annotation_kind(node)!r}); register one "
                f"via PushdownRuleRegistry.register"
            )
        return fn

    def pushup_for(self, node: O.Node) -> PushupFn:
        """Pushup (output-direction) rule for ``node``.

        Args:
            node: pipeline plan operator.
        Returns:
            PushupFn: forward transfer function for placement optimization.
        Raises:
            TypeError: no pushup rule registered for the node.
        """
        fn = self._lookup("up", node)
        if fn is None:
            raise TypeError(
                f"no pushup rule registered for {type(node).__name__} "
                f"(annotation={self._annotation_kind(node)!r}); register one "
                f"via PushdownRuleRegistry.register(..., pushup=...)"
            )
        return fn


DEFAULT_REGISTRY = PushdownRuleRegistry()


# --------------------------------------------------------------------------- #
# engine
# --------------------------------------------------------------------------- #


class Pushdown:
    """Pushdown engine over a plan with precomputed per-node schemas."""

    def __init__(self, plan: O.Node, catalog_schemas: Dict[str, List[str]],
                 precise_minmax: bool = False,
                 registry: Optional[PushdownRuleRegistry] = None):
        self.plan = plan
        self.catalog_schemas = catalog_schemas
        self.precise_minmax = precise_minmax
        self.registry = registry or DEFAULT_REGISTRY
        self.schemas: Dict[int, List[str]] = {}
        for n in O.walk(plan):
            self.schemas[n.id] = O.schema(n, catalog_schemas)

    def schema_of(self, n: O.Node) -> List[str]:
        return self.schemas[n.id]

    # ------------------------------------------------------------------ #
    def push_node(self, n: O.Node, F: Expr, relaxed: bool = False) -> Push:
        """Push ``F`` (predicate over ``n``'s output) to ``n``'s children via
        the registered rule for the node's (type, annotation)."""
        if F == FALSE:
            return Push({c.id: FALSE for c in n.children}, True)
        return self.registry.rule_for(n)(self, n, F, relaxed)

    def push_up(self, n: O.Node, up: Callable, vset: Callable) -> Expr:
        """§6.1 pushup transformation of ``n`` via the registered rule —
        consumed by :class:`~repro_torch.core.iterative.IterativeInference`."""
        return self.registry.pushup_for(n)(self, n, up, vset)


# --------------------------------------------------------------------------- #
# pushdown rules — relational core (paper Table 2)
# --------------------------------------------------------------------------- #


def _push_filter(pd: Pushdown, n: O.Filter, F: Expr, relaxed: bool) -> Push:
    return Push({n.child.id: land(F, n.pred)}, True)


def _push_project(pd: Pushdown, n: O.Project, F: Expr, relaxed: bool) -> Push:
    return Push({n.child.id: F}, True)


def _push_rowtransform(pd: Pushdown, n: O.RowTransform, F: Expr,
                       relaxed: bool) -> Push:
    return Push({n.child.id: substitute_cols(F, n.assigns)}, True)


def _push_alias(pd: Pushdown, n: O.Alias, F: Expr, relaxed: bool) -> Push:
    p = n.prefix
    mapping = {p + c: Col(c) for c in pd.schema_of(n.child)}
    return Push({n.child.id: substitute_cols(F, mapping)}, True)


def _push_sort(pd: Pushdown, n: O.Sort, F: Expr, relaxed: bool) -> Push:
    return Push({n.child.id: F}, True)


def _push_union(pd: Pushdown, n: O.Union, F: Expr, relaxed: bool) -> Push:
    return Push({p.id: F for p in n.parts}, True)


def _push_intersect(pd: Pushdown, n: O.Intersect, F: Expr,
                    relaxed: bool) -> Push:
    # the right-side contribution to an output row's lineage is the
    # VALUE-MATCHING right rows; F captures them exactly only when it
    # pins every output column (full row equality).  A partial pin
    # over-selects (fuzzer-found, corpus intersect_partial_pins) —
    # imprecise, so Algorithm 1 materializes this node and re-pins.
    pins = pins_of(F)
    out_cols = set(pd.schema_of(n))
    precise = out_cols <= set(pins)
    req: Set[str] = set()
    if precise:
        for c in out_cols:
            req |= _pin_param(pins[c])
    return Push({n.left.id: F, n.right.id: F}, precise, required=req)


def _push_join(pd: Pushdown, n, F: Expr, relaxed: bool) -> Push:
    lcols = set(pd.schema_of(n.left))
    rcols_full = set(pd.schema_of(n.right))
    # columns visible from the right in the joined output (dups hidden)
    rcols = rcols_full - lcols
    (latoms, ratoms), bad = _split_atoms(F, [lcols, rcols])
    pins = pins_of(F)
    # OR-split relaxation for mixed-side disjunctions (sound superset)
    for a in bad:
        l_part, r_part = _or_split(a, [lcols, rcols])
        if l_part is not None:
            latoms.append(l_part)
        if r_part is not None:
            ratoms.append(r_part)
    # key transfer: a pin on either key column mirrors to the other side
    guards: Dict[int, List[str]] = {}
    keys_pinned = True
    for lk, rk in n.on:
        pin = pins.get(lk) or pins.get(rk)
        if pin is None:
            keys_pinned = False
            continue
        if lk in pins:
            ratoms.append(_pin_atom(rk, pins[lk]))
        if rk in pins and rk in rcols:
            latoms.append(_pin_atom(lk, pins[rk]))
        elif rk not in pins and lk in pins:
            pass
    g_l, g_r = land(*latoms), land(*ratoms)
    required: Set[str] = set()
    for lk, rk in n.on:
        for c in (lk, rk):
            if c in pins:
                required |= _pin_param(pins[c])
    # a dropped mixed-side atom is harmless when all its columns are
    # pinned to scalars: under a real output row's binding it evaluates to
    # a true constant (e.g. Q7/Q19-style OR conditions over both sides)
    unsafe_bad = []
    for a in bad:
        if all(c in pins and not isinstance(pins[c], IsIn) for c in cols_of(a)):
            for c in cols_of(a):
                required |= _pin_param(pins[c])
        else:
            unsafe_bad.append(a)
    precise = keys_pinned and not unsafe_bad
    if n.pred is not None:
        # extra non-equi condition: precise iff all its columns are pinned
        # to scalars (then the condition holds uniformly for the pinned
        # values, which came from an actual output row).
        scalar_pin = all(
            c in pins and not isinstance(pins[c], IsIn) for c in cols_of(n.pred)
        )
        if scalar_pin:
            for c in cols_of(n.pred):
                required |= _pin_param(pins[c])
        precise = precise and scalar_pin
    if isinstance(n, O.LeftOuterJoin):
        # right-side predicate only applies when t_o's right columns are
        # non-NULL; collect the params that bind from right columns.
        gp = []
        for a in conjuncts(g_r):
            for p in _atom_params(a):
                gp.append(p)
        guards[n.right.id] = gp
    return Push({n.left.id: g_l, n.right.id: g_r}, precise, dropped=bad,
                guards=guards, required=required)


def _push_semi(pd: Pushdown, n, F: Expr, relaxed: bool) -> Push:
    ocols = set(pd.schema_of(n.outer))
    pins = pins_of(F)
    inner_atoms: List[Expr] = []
    keys_pinned = True
    for ok_, ik in n.on:
        if ok_ in pins:
            inner_atoms.append(_pin_atom(ik, pins[ok_]))
        else:
            keys_pinned = False
    pred_ok = True
    if n.pred is not None:
        # substitute pinned outer columns into the correlation predicate
        pcols = cols_of(n.pred) & ocols
        if all(c in pins for c in pcols):
            mapping = {c: pins[c] if not isinstance(pins[c], IsIn) else Col(c) for c in pcols}
            if all(not isinstance(pins[c], IsIn) for c in pcols):
                inner_atoms.append(substitute_cols(n.pred, mapping))
            else:
                pred_ok = False
        else:
            pred_ok = False
    required: Set[str] = set()
    for ok2, ik in n.on:
        if ok2 in pins:
            required |= _pin_param(pins[ok2])
    if n.pred is not None:
        for c in cols_of(n.pred) & ocols:
            if c in pins:
                required |= _pin_param(pins[c])
    if isinstance(n, O.AntiJoin):
        # inner lineage is the empty set (paper Table 2)
        g_inner = FALSE
        precise = keys_pinned and (n.pred is None or pred_ok)
        return Push({n.outer.id: F, n.inner.id: g_inner}, precise, required=required)
    g_inner = land(*inner_atoms) if (keys_pinned and pred_ok) else (
        land(*inner_atoms) if inner_atoms else TRUE
    )
    precise = keys_pinned and pred_ok
    return Push({n.outer.id: F, n.inner.id: g_inner}, precise, required=required)


def _push_groupby(pd: Pushdown, n: O.GroupBy, F: Expr, relaxed: bool) -> Push:
    keys = set(n.keys)
    per, bad = _split_atoms(F, [keys])
    atoms = per[0]
    pins = pins_of(F)
    keys_pinned = all(k in pins for k in n.keys)
    dropped = []
    for a in bad:
        acols = cols_of(a)
        if acols <= keys | set(n.aggs):
            # atom touching aggregate outputs: droppable (group lineage)
            if pd.precise_minmax and keys_pinned:
                ref = _minmax_refine(n, a)
                if ref is not None:
                    atoms.append(ref)
                    continue
            dropped.append(a)
        else:
            dropped.append(a)
    required: Set[str] = set()
    for k2 in n.keys:
        if k2 in pins:
            required |= _pin_param(pins[k2])
    return Push({n.child.id: land(*atoms)}, keys_pinned, dropped=dropped,
                required=required)


def _push_pivot(pd: Pushdown, n: O.Pivot, F: Expr, relaxed: bool) -> Push:
    keys = {n.index}
    per, bad = _split_atoms(F, [keys])
    pins = pins_of(F)
    precise = n.index in pins
    req = _pin_param(pins[n.index]) if n.index in pins else set()
    return Push({n.child.id: land(*per[0])}, precise, dropped=bad,
                required=req)


def _push_unpivot(pd: Pushdown, n: O.Unpivot, F: Expr, relaxed: bool) -> Push:
    pins = pins_of(F)
    idx_atoms = [a for a in conjuncts(F) if cols_of(a) <= set(n.index_cols)]
    branches = []
    for i, vc in enumerate(n.value_cols):
        mapping = {n.var_name: Lit(i), n.value_name: Col(vc)}
        sub = substitute_cols(land(*[a for a in conjuncts(F) if not cols_of(a) <= set(n.index_cols)]), mapping)
        branches.append(sub)
    g = land(land(*idx_atoms), lor(*branches) if branches else TRUE)
    precise = all(k in pins for k in n.index_cols)
    req = set()
    for k2 in n.index_cols:
        if k2 in pins:
            req |= _pin_param(pins[k2])
    return Push({n.child.id: g}, precise, required=req)


def _push_rowexpand(pd: Pushdown, n: O.RowExpand, F: Expr,
                    relaxed: bool) -> Push:
    branches = []
    base_cols = set(pd.schema_of(n.child))
    ok = True
    for variant in n.variants:
        g = substitute_cols(F, variant)
        if not cols_of(g) <= base_cols:
            ok = False
            continue
        branches.append(g)
    g = lor(*branches) if branches else TRUE
    return Push({n.child.id: g}, ok and bool(branches))


def _push_window(pd: Pushdown, n: O.Window, F: Expr, relaxed: bool) -> Push:
    # Positional/window lineage: precise iff the (unique) order column is
    # pinned — G selects the trailing window by order-column range.  Our
    # executor also emits __pos__; pins on __pos__ can't map to input
    # values without data => imprecise (materialize).
    idx = n.order_by[0] if n.order_by else None
    pins = pins_of(F)
    if idx is None or idx not in pins or isinstance(pins[idx], IsIn):
        # no usable order pin: an output row's lineage includes its
        # trailing-window *contributor* rows, which satisfy none of F's
        # atoms in general — keeping pass-through atoms here produced
        # lineage undersets (fuzzer-found, corpus window_groupby).  The
        # sound relaxation drops everything.
        return Push({n.child.id: TRUE}, False, dropped=list(conjuncts(F)))
    v = pins[idx]
    # trailing `size` rows by the order column (dense integer index
    # contract — documented for pipeline builders)
    g = land(Col(idx) <= v, Col(idx) > BinOp("-", v, Lit(n.size)))
    return Push({n.child.id: g}, True, required=_pin_param(v))


def _push_groupedmap(pd: Pushdown, n: O.GroupedMap, F: Expr,
                     relaxed: bool) -> Push:
    keys = set(n.keys)
    per, bad = _split_atoms(F, [keys])
    pins = pins_of(F)
    precise = all(k in pins for k in n.keys)
    req = set()
    for k2 in n.keys:
        if k2 in pins:
            req |= _pin_param(pins[k2])
    return Push({n.child.id: land(*per[0])}, precise, dropped=bad,
                required=req)


def _push_scalar_sub(pd: Pushdown, n: O.FilterScalarSub, F: Expr,
                     relaxed: bool) -> Push:
    pins = pins_of(F)
    inner_atoms = []
    corr_pinned = True
    for oc, ic in n.correlate:
        if oc in pins:
            inner_atoms.append(_pin_atom(ic, pins[oc]))
        else:
            corr_pinned = False
    # outer side keeps F; precise when the correlation keys and the
    # comparison's outer columns are pinned (comparison outcome is then
    # uniform across selected rows).
    expr_pinned = all(c in pins for c in cols_of(n.outer_expr))
    required: Set[str] = set()
    for oc, ic in n.correlate:
        if oc in pins:
            required |= _pin_param(pins[oc])
    for c in cols_of(n.outer_expr):
        if c in pins:
            required |= _pin_param(pins[c])
    if not n.correlate:
        g_inner = TRUE  # whole inner table feeds the global scalar
        precise = expr_pinned
    else:
        g_inner = land(*inner_atoms) if corr_pinned else TRUE
        precise = corr_pinned and expr_pinned
    return Push({n.child.id: F, n.inner.id: g_inner}, precise, required=required)


# --------------------------------------------------------------------------- #
# pushdown rules — UDF family (annotation-driven, paper's UDF coverage)
# --------------------------------------------------------------------------- #


def _udf_drop_split(F: Expr, out_set: Set[str]):
    """Conjuncts that survive a UDF boundary vs those touching its outputs."""
    keep, dropped = [], []
    for a in conjuncts(F):
        (dropped if cols_of(a) & out_set else keep).append(a)
    return keep, dropped


def _udf_determined(F: Expr, det: Sequence[str], out_set: Set[str],
                    dropped: List[Expr]):
    """Are the dropped atoms' values *determined* under F's pins?

    A deterministic UDF's outputs are a function of its determining input
    columns; when every determining column (and every non-output column a
    dropped atom touches) is pinned to a scalar by F — pins that came from an
    actual output row — the dropped atoms evaluate to true constants, so
    dropping them loses nothing (the same argument as the join rule's
    safe-drop).  Returns (ok, required pin params)."""
    pins = pins_of(F)
    need = set(det)
    for a in dropped:
        need |= cols_of(a) - out_set
    ok = all(
        c not in out_set and c in pins and not isinstance(pins[c], IsIn)
        for c in need
    )
    required: Set[str] = set()
    if ok:
        for c in need:
            required |= _pin_param(pins[c])
    return ok, required


def _push_map_udf(pd: Pushdown, n: O.MapUDF, F: Expr, relaxed: bool) -> Push:
    """row_preserving / one_to_one: output row i IS input row i, so atoms on
    pass-through columns push unchanged; atoms on UDF outputs drop, precisely
    iff the determining columns are scalar-pinned."""
    out_set = set(n.out_cols)
    keep, dropped = _udf_drop_split(F, out_set)
    det = n.annotation.determines(n.cols)
    ok, required = _udf_determined(F, det, out_set, dropped)
    precise = (not dropped) or ok
    return Push({n.child.id: land(*keep)}, precise, dropped=dropped,
                required=required if dropped else set())


def _push_filter_udf(pd: Pushdown, n: O.FilterUDF, F: Expr,
                     relaxed: bool) -> Push:
    """filter_like: the body is deterministic and re-executable, so the
    pushed predicate carries it verbatim (a UDFExpr atom evaluated by the
    scan engines at query time) — precise, exactly like a closed-form
    Filter."""
    return Push({n.child.id: land(F, n.pred_expr())}, True)


def _push_expand_udf(pd: Pushdown, n: O.ExpandUDF, F: Expr,
                     relaxed: bool) -> Push:
    """one_to_many: each output row's pass-through columns repeat its parent,
    so surviving atoms push soundly; precision additionally needs the
    determining columns pinned (k may be 0 — an input matching the
    pass-through atoms can have produced nothing)."""
    out_set = set(n.out_cols)
    keep, dropped = _udf_drop_split(F, out_set)
    det = n.annotation.determines(n.cols)
    ok, required = _udf_determined(F, det, out_set, dropped)
    return Push({n.child.id: land(*keep)}, ok, dropped=dropped,
                required=required)


def _push_opaque_udf(pd: Pushdown, n: O.OpaqueUDF, F: Expr,
                     relaxed: bool) -> Push:
    """opaque: no row correspondence — lineage through the operator is the
    whole input (the paper's well-defined superset), pushed as TRUE.  The
    SUPERSET marker makes Algorithm 1 materialize this node's output
    unconditionally; an unmaterialized opaque stage degrades every table
    below it to a flagged superset."""
    return Push({n.child.id: TRUE}, True, dropped=list(conjuncts(F)),
                superset=True)


# --------------------------------------------------------------------------- #
# pushup rules — §6.1 transformations (consumed by core/iterative.py)
# --------------------------------------------------------------------------- #


def _up_source(pd, n: O.Source, up, vset) -> Expr:
    return land(*[IsIn(Col(c), vset(n, c)) for c in pd.schema_of(n)])


def _up_child(pd, n, up, vset) -> Expr:
    return up(n.main_child)


def _up_project(pd, n: O.Project, up, vset) -> Expr:
    keep = set(n.keep)
    return land(*[a for a in conjuncts(up(n.child)) if cols_of(a) <= keep])


def _up_shadowed(shadowed_of):
    def rule(pd, n, up, vset) -> Expr:
        shadowed = set(shadowed_of(n))
        return land(*[a for a in conjuncts(up(n.child))
                      if not (cols_of(a) & shadowed)])

    return rule


def _up_alias(pd, n: O.Alias, up, vset) -> Expr:
    mapping = {c: Col(n.prefix + c) for c in pd.schema_of(n.child)}
    return substitute_cols(up(n.child), mapping)


def _up_inner_join(pd, n: O.InnerJoin, up, vset) -> Expr:
    atoms = conjuncts(up(n.left)) + [
        a for a in conjuncts(up(n.right))
        if cols_of(a) <= set(pd.schema_of(n))
    ]
    # joined rows carry both keys' V-sets (lk == rk on every row)
    l_mem = _memberships(up(n.left))
    r_mem = _memberships(up(n.right))
    for lk, rk in n.on:
        if rk in r_mem:
            atoms.append(IsIn(Col(lk), r_mem[rk]))
        if lk in l_mem and rk in set(pd.schema_of(n)):
            atoms.append(IsIn(Col(rk), l_mem[lk]))
    return land(*atoms)


def _up_left_outer(pd, n: O.LeftOuterJoin, up, vset) -> Expr:
    # unmatched left rows break right-side guarantees: left only
    return up(n.left)


def _up_semi(pd, n: O.SemiJoin, up, vset) -> Expr:
    atoms = conjuncts(up(n.outer))
    i_mem = _memberships(up(n.inner))
    for ok_, ik in n.on:
        if ik in i_mem:
            atoms.append(IsIn(Col(ok_), i_mem[ik]))
    return land(*atoms)


def _up_anti(pd, n: O.AntiJoin, up, vset) -> Expr:
    # inner lineage information cannot be pushed up (paper §6.4) but the
    # inner subtree must still be traversed so phase 3 can refine *within* it
    up(n.inner)
    return up(n.outer)


def _up_scalar_sub(pd, n: O.FilterScalarSub, up, vset) -> Expr:
    atoms = conjuncts(up(n.child))
    i_mem = _memberships(up(n.inner))  # always traverse the inner
    if n.correlate:
        for oc, ic in n.correlate:
            if ic in i_mem:
                atoms.append(IsIn(Col(oc), i_mem[ic]))
    return land(*atoms)


def _up_keys(keys_of):
    def rule(pd, n, up, vset) -> Expr:
        keys = set(keys_of(n))
        return land(*[a for a in conjuncts(up(n.child)) if cols_of(a) <= keys])

    return rule


def _up_union(pd, n: O.Union, up, vset) -> Expr:
    return lor(*[up(p) for p in n.parts])


def _up_intersect(pd, n: O.Intersect, up, vset) -> Expr:
    return land(up(n.left), up(n.right))


def _up_opaque_udf(pd, n: O.OpaqueUDF, up, vset) -> Expr:
    # output rows are arbitrary functions of the whole input: nothing from
    # below survives the boundary, but the subtree is still traversed so
    # refinement can tighten V-sets *within* it
    up(n.child)
    return TRUE


# --------------------------------------------------------------------------- #
# default registrations
# --------------------------------------------------------------------------- #

DEFAULT_REGISTRY.register(O.Source, pushup=_up_source)
DEFAULT_REGISTRY.register(O.Filter, _push_filter, pushup=_up_child)
DEFAULT_REGISTRY.register(O.Project, _push_project, pushup=_up_project)
DEFAULT_REGISTRY.register(O.RowTransform, _push_rowtransform,
                          pushup=_up_shadowed(lambda n: n.assigns))
DEFAULT_REGISTRY.register(O.Alias, _push_alias, pushup=_up_alias)
DEFAULT_REGISTRY.register(O.Sort, _push_sort, pushup=_up_child)
DEFAULT_REGISTRY.register(O.Union, _push_union, pushup=_up_union)
DEFAULT_REGISTRY.register(O.Intersect, _push_intersect, pushup=_up_intersect)
DEFAULT_REGISTRY.register(O.InnerJoin, _push_join, pushup=_up_inner_join)
DEFAULT_REGISTRY.register(O.LeftOuterJoin, _push_join, pushup=_up_left_outer)
DEFAULT_REGISTRY.register(O.SemiJoin, _push_semi, pushup=_up_semi)
DEFAULT_REGISTRY.register(O.AntiJoin, _push_semi, pushup=_up_anti)
DEFAULT_REGISTRY.register(O.GroupBy, _push_groupby,
                          pushup=_up_keys(lambda n: n.keys))
DEFAULT_REGISTRY.register(O.Pivot, _push_pivot,
                          pushup=_up_keys(lambda n: [n.index]))
DEFAULT_REGISTRY.register(O.Unpivot, _push_unpivot,
                          pushup=_up_keys(lambda n: n.index_cols))
DEFAULT_REGISTRY.register(O.RowExpand, _push_rowexpand,
                          pushup=_up_shadowed(
                              lambda n: {c for v in n.variants for c in v}))
DEFAULT_REGISTRY.register(O.Window, _push_window, pushup=_up_child)
DEFAULT_REGISTRY.register(O.GroupedMap, _push_groupedmap,
                          pushup=_up_shadowed(lambda n: n.assigns))
DEFAULT_REGISTRY.register(O.FilterScalarSub, _push_scalar_sub,
                          pushup=_up_scalar_sub)
# UDF family: dispatched per annotation kind so third-party annotation
# classes can override one class of behaviour without replacing the operator
DEFAULT_REGISTRY.register(O.MapUDF, _push_map_udf,
                          pushup=_up_shadowed(lambda n: n.out_cols))
DEFAULT_REGISTRY.register(O.FilterUDF, _push_filter_udf,
                          annotation="filter_like", pushup=_up_child)
DEFAULT_REGISTRY.register(O.ExpandUDF, _push_expand_udf,
                          pushup=_up_shadowed(lambda n: n.out_cols))
DEFAULT_REGISTRY.register(O.OpaqueUDF, _push_opaque_udf,
                          annotation="opaque", pushup=_up_opaque_udf)


def _atom_params(a: Expr) -> List[str]:
    from .expr import params_of

    return sorted(params_of(a))


def _minmax_refine(n: O.GroupBy, atom: Expr) -> Optional[Expr]:
    """Beyond-paper option: for ``agg_out == v`` with agg min/max, select only
    the extremal rows (paper default keeps the whole group)."""
    if isinstance(atom, BinOp) and atom.op == "==":
        l, r = atom.left, atom.right
        col, rhs = (l, r) if isinstance(l, Col) else (r, l) if isinstance(r, Col) else (None, None)
        if col is not None and col.name in n.aggs:
            agg = n.aggs[col.name]
            if agg.fn in ("min", "max") and agg.expr is not None:
                return BinOp("==", agg.expr, rhs)
    return None
