"""Operator / plan IR for PredTrace — the operator set of paper Table 2.

Plans are trees of ``Node``s with ``Source`` leaves.  Sub-queries (semi/anti
joins, correlated scalar sub-queries, grouped maps) hold their inner plan as a
child subtree, mirroring the paper's pipeline syntax for TPC-H Q4 (Figure 1).

Static schema inference (``schema``) is provided so the pushdown engine can
reason about plans without executing them.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .expr import Col, Expr, LineageAnnotation, Lit, UDFExpr, cols_of

_node_ids = itertools.count()


class Node:
    """Base plan node."""

    def __post_init__(self):
        object.__setattr__(self, "id", next(_node_ids))

    @property
    def children(self) -> List["Node"]:
        out = []
        for f in getattr(self, "__dataclass_fields__", {}):
            v = getattr(self, f)
            if isinstance(v, Node):
                out.append(v)
            elif isinstance(v, (list, tuple)) and v and isinstance(v[0], Node):
                out.extend(v)
        return out

    # ``main_child`` is the input that carries the pipeline's main dataflow
    # (the paper's operator sequence); side inputs are sub-query plans.
    @property
    def main_child(self) -> Optional["Node"]:
        ch = self.children
        return ch[0] if ch else None

    def __repr_args__(self) -> str:
        return ""

    def __repr__(self):
        return f"{type(self).__name__}#{self.id}({self.__repr_args__()})"


@dataclass(frozen=True, eq=False)
class Agg:
    fn: str  # sum | count | min | max | mean | count_distinct | any | udf:<name>
    expr: Optional[Expr] = None  # None for count(*)

    def __repr__(self):
        return f"{self.fn}({self.expr if self.expr is not None else '*'})"


@dataclass(eq=False)
class Source(Node):
    table: str

    def __post_init__(self):
        Node.__post_init__(self)

    def __repr_args__(self):
        return self.table


@dataclass(eq=False)
class Filter(Node):
    child: Node
    pred: Expr

    def __post_init__(self):
        Node.__post_init__(self)

    def __repr_args__(self):
        return str(self.pred)


@dataclass(eq=False)
class Project(Node):
    """DropColumn in the paper: keep only ``keep`` columns."""

    child: Node
    keep: List[str]

    def __post_init__(self):
        Node.__post_init__(self)

    def __repr_args__(self):
        return ",".join(self.keep)


@dataclass(eq=False)
class RowTransform(Node):
    """Adds / replaces columns: ``assigns[new_col] = Expr(input cols)``.
    Covers the paper's RowTransform with embedded (symbolically executable)
    UDFs — the UDF body *is* the Expr."""

    child: Node
    assigns: Dict[str, Expr]

    def __post_init__(self):
        Node.__post_init__(self)

    def __repr_args__(self):
        return ",".join(self.assigns)


@dataclass(eq=False)
class Alias(Node):
    """Prefix-rename every column (for self-joins)."""

    child: Node
    prefix: str

    def __post_init__(self):
        Node.__post_init__(self)

    def __repr_args__(self):
        return self.prefix


@dataclass(eq=False)
class InnerJoin(Node):
    left: Node
    right: Node
    on: List[Tuple[str, str]]  # (left_col, right_col) equi-keys
    pred: Optional[Expr] = None  # extra non-equi condition over merged schema

    def __post_init__(self):
        Node.__post_init__(self)

    def __repr_args__(self):
        return ",".join(f"{l}={r}" for l, r in self.on)


@dataclass(eq=False)
class LeftOuterJoin(Node):
    left: Node
    right: Node
    on: List[Tuple[str, str]]
    pred: Optional[Expr] = None

    def __post_init__(self):
        Node.__post_init__(self)

    def __repr_args__(self):
        return ",".join(f"{l}={r}" for l, r in self.on)


@dataclass(eq=False)
class SemiJoin(Node):
    """EXISTS / IN sub-query.  Keeps outer rows with >=1 match in the inner
    plan on the equi-keys (plus optional extra predicate over both schemas)."""

    outer: Node
    inner: Node
    on: List[Tuple[str, str]]  # (outer_col, inner_col)
    pred: Optional[Expr] = None

    def __post_init__(self):
        Node.__post_init__(self)

    def __repr_args__(self):
        return ",".join(f"{l}={r}" for l, r in self.on)


@dataclass(eq=False)
class AntiJoin(Node):
    """NOT EXISTS."""

    outer: Node
    inner: Node
    on: List[Tuple[str, str]]
    pred: Optional[Expr] = None

    def __post_init__(self):
        Node.__post_init__(self)

    def __repr_args__(self):
        return ",".join(f"{l}={r}" for l, r in self.on)


@dataclass(eq=False)
class GroupBy(Node):
    child: Node
    keys: List[str]  # empty => single global group
    aggs: Dict[str, Agg]

    def __post_init__(self):
        Node.__post_init__(self)

    def __repr_args__(self):
        return ",".join(self.keys) + " | " + ",".join(self.aggs)


@dataclass(eq=False)
class Sort(Node):
    """Reorder / TopK (order-by + LIMIT N)."""

    child: Node
    by: List[Tuple[str, bool]]  # (col, ascending)
    limit: Optional[int] = None

    def __post_init__(self):
        Node.__post_init__(self)

    def __repr_args__(self):
        lim = f" limit {self.limit}" if self.limit else ""
        return ",".join(c for c, _ in self.by) + lim


@dataclass(eq=False)
class Union(Node):
    parts: List[Node]

    def __post_init__(self):
        Node.__post_init__(self)


@dataclass(eq=False)
class Intersect(Node):
    left: Node
    right: Node

    def __post_init__(self):
        Node.__post_init__(self)


@dataclass(eq=False)
class Pivot(Node):
    """index x column -> one row per index value, one output column per pivot
    value.  ``values`` must be declared statically (needed for schema/pushdown
    without executing)."""

    child: Node
    index: str
    column: str
    value: str
    agg: str = "sum"
    values: List = field(default_factory=list)  # distinct pivot values

    def __post_init__(self):
        Node.__post_init__(self)

    def out_col(self, v) -> str:
        return f"{self.column}_{v}"


@dataclass(eq=False)
class Unpivot(Node):
    child: Node
    index_cols: List[str]
    value_cols: List[str]
    var_name: str = "variable"
    value_name: str = "value"

    def __post_init__(self):
        Node.__post_init__(self)


@dataclass(eq=False)
class RowExpand(Node):
    """1-to-k transform: each input row produces ``len(variants)`` rows; each
    variant assigns output columns from input-column expressions."""

    child: Node
    variants: List[Dict[str, Expr]]

    def __post_init__(self):
        Node.__post_init__(self)


@dataclass(eq=False)
class Window(Node):
    """Rolling window op.  Sorts by ``order_by``, adds ``__pos__`` (position)
    and per-row aggregates over the trailing ``size`` rows."""

    child: Node
    order_by: List[str]
    size: int
    aggs: Dict[str, Agg]

    def __post_init__(self):
        Node.__post_init__(self)


@dataclass(eq=False)
class GroupedMap(Node):
    """Per-group transform (paper: transform grouped sub-tables with a
    subquery).  ``group_aggs`` compute per-group scalars (broadcast back);
    ``assigns`` are row-level expressions that may use them — e.g. group-wise
    normalization ``x_norm = (x - mean_x) / std_x``."""

    child: Node
    keys: List[str]
    group_aggs: Dict[str, Agg]
    assigns: Dict[str, Expr]

    def __post_init__(self):
        Node.__post_init__(self)


# --------------------------------------------------------------------------- #
# UDF operator family (annotation-driven pushdown, paper's UDF coverage)
# --------------------------------------------------------------------------- #
#
# Each node carries a :class:`~repro_torch.core.expr.LineageAnnotation` naming the
# pushdown-rule class its body belongs to; the PushdownRuleRegistry
# (``core/pushdown.py``) dispatches on (operator type, annotation kind), so
# third-party operators plug in without editing core.  Bodies come in two
# shapes — ``fn`` (vectorized over numpy columns) and ``row_fn`` (per-row
# fallback) — and must be deterministic and pure: lineage-query scans may
# re-execute them.


class UDFNode(Node):
    """Shared machinery for the UDF operator family."""

    def _check_annotation(self, allowed: Tuple[str, ...]) -> None:
        if self.annotation.kind not in allowed:
            raise ValueError(
                f"{type(self).__name__} supports annotations {allowed}, "
                f"got {self.annotation.kind!r}"
            )
        if self.fn is None and self.row_fn is None:
            raise ValueError(f"{type(self).__name__} needs fn or row_fn")
        unknown = set(self.annotation.key_cols) - set(self.cols)
        if unknown:
            raise ValueError(f"annotation key_cols {unknown} not in declared "
                             f"input columns {self.cols}")


@dataclass(eq=False)
class MapUDF(UDFNode):
    """Row-preserving UDF: adds/replaces ``out_cols`` computed from the
    declared input columns ``cols``; emits exactly the input rows, in order.

    ``fn(*arrays) -> array | tuple(arrays) | {out_col: array}`` (vectorized)
    or ``row_fn(*scalars) -> scalar | tuple | dict`` (per-row fallback).
    Annotations: ``row_preserving`` (default; outputs depend on every
    declared input column) or ``one_to_one`` (outputs depend only on the
    annotation's ``key_cols``)."""

    child: Node
    cols: List[str]
    out_cols: List[str]
    fn: Optional[Callable] = None
    row_fn: Optional[Callable] = None
    annotation: LineageAnnotation = field(
        default_factory=LineageAnnotation.row_preserving
    )
    name: str = "map_udf"

    def __post_init__(self):
        Node.__post_init__(self)
        self._check_annotation(("row_preserving", "one_to_one"))

    def __repr_args__(self):
        return f"{self.name}:{','.join(self.out_cols)}"


@dataclass(eq=False)
class FilterUDF(UDFNode):
    """Filter-like UDF: keeps the input rows where the boolean body holds;
    schema unchanged.  ``fn(*arrays) -> bool mask`` / ``row_fn(*scalars) ->
    bool``.  Because the body is deterministic and re-executable, the
    pushdown rule conjoins it into the pushed predicate (as a
    :class:`~repro_torch.core.expr.UDFExpr`) — the paper's filter-like rule, which
    keeps the pushdown *precise*."""

    child: Node
    cols: List[str]
    fn: Optional[Callable] = None
    row_fn: Optional[Callable] = None
    annotation: LineageAnnotation = field(
        default_factory=LineageAnnotation.filter_like
    )
    name: str = "filter_udf"

    def __post_init__(self):
        Node.__post_init__(self)
        self._check_annotation(("filter_like",))

    def __repr_args__(self):
        return f"{self.name}({','.join(self.cols)})"

    def pred_expr(self) -> UDFExpr:
        """The keep-decision as a pushable predicate atom.  The name embeds
        the node id so structural caches never conflate two bodies."""
        vec = self.fn
        row = self.row_fn

        def mask_fn(*arrays):
            if vec is not None:
                return np.asarray(vec(*arrays), dtype=bool)
            n = len(arrays[0]) if arrays else 0
            return np.fromiter(
                (bool(row(*(a[i] for a in arrays))) for i in range(n)),
                dtype=bool, count=n,
            )

        return UDFExpr(f"{self.name}#{self.id}", mask_fn,
                       tuple(Col(c) for c in self.cols))


@dataclass(eq=False)
class ExpandUDF(UDFNode):
    """One-to-many UDF: each input row yields k >= 0 output rows; the new
    ``out_cols`` are a function of the declared input columns, pass-through
    columns repeat the parent row's values.

    ``fn(*arrays) -> (parent_idx, {out_col: array} | tuple(arrays))``
    (vectorized: ``parent_idx[i]`` is the input row of output row ``i``) or
    ``row_fn(*scalars) -> list[dict | tuple]`` (per-row fallback, one entry
    per produced row)."""

    child: Node
    cols: List[str]
    out_cols: List[str]
    fn: Optional[Callable] = None
    row_fn: Optional[Callable] = None
    annotation: LineageAnnotation = field(
        default_factory=LineageAnnotation.one_to_many
    )
    name: str = "expand_udf"

    def __post_init__(self):
        Node.__post_init__(self)
        self._check_annotation(("one_to_many", "one_to_one"))

    def __repr_args__(self):
        return f"{self.name}:{','.join(self.out_cols)}"


@dataclass(eq=False)
class OpaqueUDF(Node):
    """Opaque table -> table UDF: no input/output row correspondence is
    assumed.  Lineage through it is the *whole input* — the paper's
    well-defined superset — and Algorithm 1 treats the node as a mandatory
    materialization boundary: with its output saved, everything above it
    stays precise; unmaterialized, answers degrade to flagged supersets.

    ``fn(table) -> Table | {col: array}``; ``out_schema`` must be declared
    statically so pushdown can reason without executing."""

    child: Node
    fn: Callable
    out_schema: List[str]
    annotation: LineageAnnotation = field(
        default_factory=LineageAnnotation.opaque
    )
    name: str = "opaque_udf"

    def __post_init__(self):
        Node.__post_init__(self)
        if self.annotation.kind != "opaque":
            raise ValueError("OpaqueUDF requires the opaque annotation")

    def __repr_args__(self):
        return f"{self.name}->{','.join(self.out_schema)}"


@dataclass(eq=False)
class FilterScalarSub(Node):
    """Correlated / uncorrelated scalar sub-query filter:

        keep outer rows where  outer_expr  <cmp>  scale * agg(inner group)

    where the inner group matches on ``correlate`` equi-pairs (empty =>
    uncorrelated global scalar).  Rows with an empty inner group are dropped
    (SQL NULL comparison semantics)."""

    child: Node
    inner: Node
    correlate: List[Tuple[str, str]]  # (outer_col, inner_col)
    agg: Agg
    cmp: str  # == != < <= > >=
    outer_expr: Expr
    scale: float = 1.0

    def __post_init__(self):
        Node.__post_init__(self)


# --------------------------------------------------------------------------- #
# plan utilities
# --------------------------------------------------------------------------- #


def walk(node: Node):
    """Post-order walk (children before parents)."""
    seen = set()

    def rec(n: Node):
        if n.id in seen:
            return
        seen.add(n.id)
        for c in n.children:
            yield from rec(c)
        yield n

    yield from rec(node)


def sources(node: Node) -> List[Source]:
    return [n for n in walk(node) if isinstance(n, Source)]


def main_path(node: Node) -> List[Node]:
    """The operator sequence along the main dataflow, output-first."""
    out = []
    cur: Optional[Node] = node
    while cur is not None:
        out.append(cur)
        cur = cur.main_child
    return out


def schema(node: Node, catalog: Dict[str, List[str]]) -> List[str]:
    """Static output-column inference."""
    if isinstance(node, Source):
        return list(catalog[node.table])
    if isinstance(node, Filter):
        return schema(node.child, catalog)
    if isinstance(node, Project):
        return list(node.keep)
    if isinstance(node, RowTransform):
        base = schema(node.child, catalog)
        return base + [c for c in node.assigns if c not in base]
    if isinstance(node, Alias):
        return [node.prefix + c for c in schema(node.child, catalog)]
    if isinstance(node, (InnerJoin, LeftOuterJoin)):
        l = schema(node.left, catalog)
        r = schema(node.right, catalog)
        dup = set(l) & set(r)
        joined_r = [c for c in r if c not in dup]
        return l + joined_r
    if isinstance(node, (SemiJoin, AntiJoin)):
        return schema(node.outer, catalog)
    if isinstance(node, GroupBy):
        return list(node.keys) + list(node.aggs)
    if isinstance(node, Sort):
        return schema(node.child, catalog)
    if isinstance(node, Union):
        return schema(node.parts[0], catalog)
    if isinstance(node, Intersect):
        return schema(node.left, catalog)
    if isinstance(node, Pivot):
        return [node.index] + [node.out_col(v) for v in node.values]
    if isinstance(node, Unpivot):
        return list(node.index_cols) + [node.var_name, node.value_name]
    if isinstance(node, RowExpand):
        base = schema(node.child, catalog)
        extra = sorted({c for v in node.variants for c in v})
        return base + [c for c in extra if c not in base]
    if isinstance(node, Window):
        return schema(node.child, catalog) + ["__pos__"] + list(node.aggs)
    if isinstance(node, GroupedMap):
        base = schema(node.child, catalog)
        return base + [c for c in node.assigns if c not in base]
    if isinstance(node, FilterScalarSub):
        return schema(node.child, catalog)
    if isinstance(node, (MapUDF, ExpandUDF)):
        base = schema(node.child, catalog)
        return base + [c for c in node.out_cols if c not in base]
    if isinstance(node, FilterUDF):
        return schema(node.child, catalog)
    if isinstance(node, OpaqueUDF):
        return list(node.out_schema)
    raise TypeError(f"schema: unknown node {type(node)}")


def validate(node: Node, catalog: Dict[str, List[str]]) -> None:
    """Sanity-check column references in a plan (raises on error)."""
    for n in walk(node):
        cols = set(schema(n, catalog))
        if isinstance(n, Filter):
            missing = cols_of(n.pred) - set(schema(n.child, catalog))
            if missing:
                raise ValueError(f"{n}: filter references missing columns {missing}")
        if isinstance(n, (InnerJoin, LeftOuterJoin)):
            ls, rs = set(schema(n.left, catalog)), set(schema(n.right, catalog))
            for l, r in n.on:
                if l not in ls or r not in rs:
                    raise ValueError(f"{n}: join key {l}={r} missing")
        if isinstance(n, (SemiJoin, AntiJoin)):
            ls, rs = set(schema(n.outer, catalog)), set(schema(n.inner, catalog))
            for l, r in n.on:
                if l not in ls or r not in rs:
                    raise ValueError(f"{n}: semi/anti key {l}={r} missing")
        if isinstance(n, (MapUDF, FilterUDF, ExpandUDF)):
            missing = set(n.cols) - set(schema(n.child, catalog))
            if missing:
                raise ValueError(f"{n}: UDF reads missing columns {missing}")
