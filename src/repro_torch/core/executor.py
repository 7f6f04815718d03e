"""NumPy oracle executor for PredTrace plans.

Executes a plan tree bottom-up over :class:`~repro_torch.core.table.Table`s.  This is
the host-side "database engine": dynamic cardinalities are fine here.  The
device (``ScanEngine`` on the torch backend + ``kernels/``) only executes the
predicate scans — Filter evaluation and the *lineage-query* hot path —
matching the paper's observation that lineage queries reduce to table
scans.

The executor also
  * captures per-operator stats (rows, bytes) — used by Algorithm 2's
    intermediate-result size optimization in place of DBMS estimates, and
  * materializes the outputs of a requested set of operators (optionally
    column-projected), implementing the paper's pipeline-execution phase.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import ops as O
from .expr import Expr, eval_np
from .scan import ScanEngine
from .store import IntermediateStore
from .table import (
    RID, Table, concat_tables, partition_table,
)


# --------------------------------------------------------------------------- #
# key encoding / join machinery
# --------------------------------------------------------------------------- #


def composite_codes(parts_a: Sequence[np.ndarray], parts_b: Sequence[np.ndarray]):
    """Encode multi-column keys into int64 codes consistent across two sides."""
    na = len(parts_a[0]) if parts_a else 0
    codes_a = np.zeros(na, dtype=np.int64)
    nb = len(parts_b[0]) if parts_b else 0
    codes_b = np.zeros(nb, dtype=np.int64)
    for a, b in zip(parts_a, parts_b):
        both = np.concatenate([a, b])
        _, inv = np.unique(both, return_inverse=True)
        k = inv.max(initial=0) + 1
        codes_a = codes_a * k + inv[:na]
        codes_b = codes_b * k + inv[na:]
    return codes_a, codes_b


def join_indices(codes_l: np.ndarray, codes_r: np.ndarray):
    """All matching (left_idx, right_idx) pairs for equal codes (hash join)."""
    order = np.argsort(codes_r, kind="stable")
    sorted_r = codes_r[order]
    lo = np.searchsorted(sorted_r, codes_l, side="left")
    hi = np.searchsorted(sorted_r, codes_l, side="right")
    counts = hi - lo
    li = np.repeat(np.arange(len(codes_l)), counts)
    # flatten ranges [lo_i, hi_i) for each left row
    if len(li) == 0:
        return li, li.copy()
    offsets = np.concatenate([[0], np.cumsum(counts)])[:-1]
    within = np.arange(counts.sum()) - np.repeat(offsets, counts)
    ri = order[np.repeat(lo, counts) + within]
    return li, ri


def group_codes(parts: Sequence[np.ndarray], n: int):
    """Group id per row + unique-group representative indices."""
    if not parts:
        return np.zeros(n, dtype=np.int64), np.array([0] if n else [], dtype=np.int64), 1 if n else 0
    codes = np.zeros(n, dtype=np.int64)
    for a in parts:
        _, inv = np.unique(a, return_inverse=True)
        codes = codes * (inv.max(initial=0) + 1) + inv
    uniq, first_idx, inv = np.unique(codes, return_index=True, return_inverse=True)
    return inv, first_idx, len(uniq)


def _agg_reduce(fn: str, values: Optional[np.ndarray], gid: np.ndarray, ngroups: int):
    if fn == "count":
        return np.bincount(gid, minlength=ngroups).astype(np.int64)
    assert values is not None, f"agg {fn} needs an expression"
    if fn == "sum":
        return np.bincount(gid, weights=values.astype(np.float64), minlength=ngroups)
    if fn == "mean":
        s = np.bincount(gid, weights=values.astype(np.float64), minlength=ngroups)
        c = np.bincount(gid, minlength=ngroups)
        return s / np.maximum(c, 1)
    if fn in ("min", "max"):
        out = np.full(ngroups, np.inf if fn == "min" else -np.inf, dtype=np.float64)
        ufn = np.minimum if fn == "min" else np.maximum
        ufn.at(out, gid, values.astype(np.float64))
        if np.issubdtype(values.dtype, np.integer):
            return out.astype(values.dtype)
        return out
    if fn == "count_distinct":
        pair = gid.astype(np.int64) * (np.int64(2) ** 32) + _rank(values)
        uniq_pairs = np.unique(pair)
        g = (uniq_pairs // (np.int64(2) ** 32)).astype(np.int64)
        return np.bincount(g, minlength=ngroups).astype(np.int64)
    if fn == "any":
        return np.bincount(gid, weights=values.astype(np.float64), minlength=ngroups) > 0
    raise ValueError(f"unsupported aggregate {fn}")


def _rank(values: np.ndarray) -> np.ndarray:
    _, inv = np.unique(values, return_inverse=True)
    return inv.astype(np.int64)


# --------------------------------------------------------------------------- #
# UDF node execution (shared with the eager oracle in core/eager.py)
# --------------------------------------------------------------------------- #


def _norm_outputs(result, out_cols: Sequence[str]) -> Dict[str, np.ndarray]:
    """Normalize a vectorized UDF body's return value — a dict, a tuple of
    arrays aligned with ``out_cols``, or a single array — into columns."""
    if isinstance(result, dict):
        missing = set(out_cols) - set(result)
        if missing:
            raise ValueError(f"UDF result missing columns {missing}")
        return {c: np.asarray(result[c]) for c in out_cols}
    if isinstance(result, (tuple, list)):
        if len(result) != len(out_cols):
            raise ValueError(
                f"UDF returned {len(result)} columns, expected {len(out_cols)}"
            )
        return {c: np.asarray(v) for c, v in zip(out_cols, result)}
    if len(out_cols) != 1:
        raise ValueError(f"UDF returned one column, expected {out_cols}")
    return {out_cols[0]: np.asarray(result)}


def map_udf_cols(n, t: Table) -> Dict[str, np.ndarray]:
    """Output columns of a MapUDF over ``t``: the vectorized body, or the
    per-row fallback stacked into columns."""
    arrays = [np.asarray(t.cols[c]) for c in n.cols]
    if n.fn is not None:
        out = _norm_outputs(n.fn(*arrays), n.out_cols)
    else:
        rows = [n.row_fn(*(a[i] for a in arrays)) for i in range(t.nrows)]
        out = _rows_to_cols(rows, n.out_cols)
    for c, v in out.items():
        if len(v) != t.nrows:
            raise ValueError(
                f"MapUDF {n.name} is annotated row-preserving but column "
                f"{c} has {len(v)} rows for {t.nrows} input rows"
            )
    return out


def expand_udf_rows(n, t: Table) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """(parent_idx, out columns) of an ExpandUDF over ``t``: output row ``i``
    repeats input row ``parent_idx[i]``'s pass-through columns."""
    arrays = [np.asarray(t.cols[c]) for c in n.cols]
    if n.fn is not None:
        parent_idx, outs = n.fn(*arrays)
        parent_idx = np.asarray(parent_idx, dtype=np.int64)
        out = _norm_outputs(outs, n.out_cols)
    else:
        parent, flat = [], []
        for i in range(t.nrows):
            produced = n.row_fn(*(a[i] for a in arrays))
            for item in produced:
                parent.append(i)
                flat.append(item)
        parent_idx = np.asarray(parent, dtype=np.int64)
        out = _rows_to_cols(flat, n.out_cols)
    for c, v in out.items():
        if len(v) != len(parent_idx):
            raise ValueError(
                f"ExpandUDF {n.name}: column {c} has {len(v)} rows but "
                f"parent_idx has {len(parent_idx)}"
            )
    return parent_idx, out


def _rows_to_cols(rows: Sequence, out_cols: Sequence[str]) -> Dict[str, np.ndarray]:
    """Stack per-row UDF results (scalar / tuple / dict per row) into columns."""
    cols: Dict[str, List] = {c: [] for c in out_cols}
    for r in rows:
        if isinstance(r, dict):
            for c in out_cols:
                cols[c].append(r[c])
        elif isinstance(r, (tuple, list)):
            for c, v in zip(out_cols, r):
                cols[c].append(v)
        else:
            cols[out_cols[0]].append(r)
    return {c: np.asarray(v) for c, v in cols.items()}


def opaque_udf_table(n, t: Table) -> Table:
    """Run an OpaqueUDF body over ``t`` and normalize to a Table with fresh
    row ids (no input/output row correspondence is assumed)."""
    out = n.fn(t)
    if isinstance(out, Table):
        cols = {c: np.asarray(out.cols[c]) for c in n.out_schema}
        dicts = out.dicts
    else:
        cols = {c: np.asarray(out[c]) for c in n.out_schema}
        # dict-returning bodies must pass dictionary CODES through for any
        # input column they re-emit; vocab survives only for declared output
        # columns (a stale vocab on a recomputed column would mis-decode)
        dicts = {c: t.dicts[c] for c in n.out_schema if c in t.dicts}
    nrows = len(next(iter(cols.values()))) if cols else 0
    cols[RID] = np.arange(nrows, dtype=np.int64)
    return Table(cols, dicts, None)


# --------------------------------------------------------------------------- #
# executor
# --------------------------------------------------------------------------- #


@dataclass
class NodeStats:
    rows: int = 0
    nbytes: int = 0
    seconds: float = 0.0


@dataclass
class ExecResult:
    output: Table
    stats: Dict[int, NodeStats]
    # node id -> materialized intermediate: a raw Table, or a compressed
    # StoredTable when the run went through an IntermediateStore
    materialized: Dict[int, object]
    seconds: float = 0.0
    store: Optional[IntermediateStore] = None


class Executor:
    """Evaluates plans over a catalog of named source tables."""

    def __init__(self, catalog: Dict[str, Table],
                 scan_engine: Optional[ScanEngine] = None,
                 device: Optional[str] = None):
        self.catalog = catalog
        # all Filter evaluation routes through the shared ScanEngine so plan
        # re-execution hits the same compiled atom programs the lineage-query
        # phase uses; without one, the torch backend on ``device`` (None:
        # the CUDA device, raising without one; "cpu": the plain version)
        self.scan_engine = scan_engine or ScanEngine("torch", device=device)

    def schemas(self) -> Dict[str, List[str]]:
        return {k: t.columns for k, t in self.catalog.items()}

    def run(
        self,
        plan: O.Node,
        materialize: Optional[Dict[int, Optional[List[str]]]] = None,
        store: Optional[IntermediateStore] = None,
        num_partitions: Optional[int] = None,
        partition_rows: Optional[int] = None,
    ) -> ExecResult:
        """Execute ``plan``.  ``materialize`` maps node-id -> columns to keep
        (None = all) for the intermediate results PredTrace decided to save.
        With a ``store``, each saved intermediate is column-projected and
        *encoded* into it (compressed columnar form) instead of being kept as
        a raw Table; ``ExecResult.materialized`` then holds StoredTables.

        ``num_partitions`` / ``partition_rows`` partition each raw saved
        intermediate into fixed-size row chunks with zone maps built here,
        during the pipeline-execution phase (store-backed runs partition at
        encode time via the store's own config instead)."""
        materialize = materialize or {}
        cache: Dict[int, Table] = {}
        stats: Dict[int, NodeStats] = {}
        saved: Dict[int, object] = {}
        t_start = time.perf_counter()

        def rec(n: O.Node) -> Table:
            if n.id in cache:
                return cache[n.id]
            t0 = time.perf_counter()
            out = self._exec(n, rec)
            dt = time.perf_counter() - t0
            stats[n.id] = NodeStats(out.nrows, out.nbytes(), dt)
            if n.id in materialize:
                keep = materialize[n.id]
                proj = out if keep is None else out.project([c for c in keep if out.has(c)])
                if store is not None:
                    proj = store.put(n.id, proj)
                else:
                    # no-op when no partitioning was requested
                    proj = partition_table(proj, num_partitions, partition_rows)
                saved[n.id] = proj
            cache[n.id] = out
            return out

        out = rec(plan)
        return ExecResult(out, stats, saved, time.perf_counter() - t_start, store=store)

    # ------------------------------------------------------------------ #
    # ------------------------------------------------------------------ #
    def _exec(self, n: O.Node, rec) -> Table:
        if isinstance(n, O.Source):
            return self.catalog[n.table]

        if isinstance(n, O.Filter):
            t = rec(n.child)
            return t.mask(self.scan_engine.scan(n.pred, t))

        if isinstance(n, O.Project):
            return rec(n.child).project(n.keep)

        if isinstance(n, O.RowTransform):
            t = rec(n.child)
            new = {c: np.asarray(eval_np(e, t.cols, n=t.nrows)) for c, e in n.assigns.items()}
            return t.with_cols(new)

        if isinstance(n, O.Alias):
            return rec(n.child).prefix(n.prefix)

        if isinstance(n, (O.InnerJoin, O.LeftOuterJoin)):
            return self._join(n, rec)

        if isinstance(n, (O.SemiJoin, O.AntiJoin)):
            return self._semi(n, rec)

        if isinstance(n, O.GroupBy):
            return self._groupby(n, rec)

        if isinstance(n, O.Sort):
            t = rec(n.child)
            keys = [t.cols[c] for c, _ in reversed(n.by)]
            asc = [a for _, a in reversed(n.by)]
            keys = [k if a else _descending(k) for k, a in zip(keys, asc)]
            order = np.lexsort(keys) if keys else np.arange(t.nrows)
            out = t.take(order)
            if n.limit is not None:
                out = out.head(n.limit)
            return out

        if isinstance(n, O.Union):
            return concat_tables([rec(p) for p in n.parts])

        if isinstance(n, O.Intersect):
            l, r = rec(n.left), rec(n.right)
            cols = l.columns
            cl, cr = composite_codes([l.cols[c] for c in cols], [r.cols[c] for c in cols])
            return l.mask(np.isin(cl, cr))

        if isinstance(n, O.Pivot):
            return self._pivot(n, rec)

        if isinstance(n, O.Unpivot):
            t = rec(n.child)
            parts = []
            for i, vc in enumerate(n.value_cols):
                cols = {c: t.cols[c] for c in n.index_cols}
                cols[n.var_name] = np.full(t.nrows, i, dtype=np.int32)
                cols[n.value_name] = t.cols[vc]
                cols[RID] = t.cols[RID]
                parts.append(Table(cols, t.dicts, t.name))
            return concat_tables(parts)

        if isinstance(n, O.RowExpand):
            t = rec(n.child)
            parts = []
            for variant in n.variants:
                new = {c: np.asarray(eval_np(e, t.cols, n=t.nrows)) for c, e in variant.items()}
                parts.append(t.with_cols(new))
            return concat_tables(parts)

        if isinstance(n, O.Window):
            return self._window(n, rec)

        if isinstance(n, O.GroupedMap):
            return self._grouped_map(n, rec)

        if isinstance(n, O.FilterScalarSub):
            return self._scalar_sub(n, rec)

        if isinstance(n, O.MapUDF):
            t = rec(n.child)
            return t.with_cols(map_udf_cols(n, t))

        if isinstance(n, O.FilterUDF):
            # the keep-decision travels as a UDFExpr predicate, so plan
            # execution shares the lineage-query scan path (engine caches,
            # partition pruning on pass-through atoms)
            t = rec(n.child)
            return t.mask(self.scan_engine.scan(n.pred_expr(), t))

        if isinstance(n, O.ExpandUDF):
            t = rec(n.child)
            parent_idx, outs = expand_udf_rows(n, t)
            return t.take(parent_idx).with_cols(outs)

        if isinstance(n, O.OpaqueUDF):
            return opaque_udf_table(n, rec(n.child))

        raise TypeError(f"exec: unknown node {type(n)}")

    # ------------------------------------------------------------------ #
    def _join(self, n, rec) -> Table:
        l, r = rec(n.left), rec(n.right)
        cl, cr = composite_codes(
            [l.cols[a] for a, _ in n.on], [r.cols[b] for _, b in n.on]
        )
        li, ri = join_indices(cl, cr)
        if n.pred is not None:
            env = {}
            for c in l.columns:
                env[c] = l.cols[c][li]
            for c in r.columns:
                if c not in env:
                    env[c] = r.cols[c][ri]
            keep = eval_np(n.pred, env, n=len(li)).astype(bool)
            li, ri = li[keep], ri[keep]

        if isinstance(n, O.LeftOuterJoin):
            matched = np.zeros(l.nrows, dtype=bool)
            matched[li] = True
            miss = np.nonzero(~matched)[0]
            li = np.concatenate([li, miss])
            ri = np.concatenate([ri, np.full(len(miss), -1, dtype=ri.dtype)])

        cols: Dict[str, np.ndarray] = {}
        for c in l.columns:
            cols[c] = l.cols[c][li]
        for c in r.columns:
            if c in cols:
                continue
            v = r.cols[c][np.maximum(ri, 0)]
            if isinstance(n, O.LeftOuterJoin):
                nullv = _null_for(v.dtype)
                v = np.where(ri >= 0, v, nullv)
            cols[c] = v
        # joined row ids: keep the LEFT side's rid as the row identity, and
        # expose the right rid as a separate internal column for the oracle.
        cols[RID] = l.cols[RID][li]
        cols["__rrid__"] = np.where(ri >= 0, r.cols[RID][np.maximum(ri, 0)], -1)
        dicts = dict(l.dicts)
        dicts.update({k: v for k, v in r.dicts.items() if k not in dicts})
        return Table(cols, dicts, None)

    def _semi(self, n, rec) -> Table:
        outer, inner = rec(n.outer), rec(n.inner)
        co, ci = composite_codes(
            [outer.cols[a] for a, _ in n.on], [inner.cols[b] for _, b in n.on]
        )
        if n.pred is None:
            if n.on:
                has = np.isin(co, ci)
            else:  # EXISTS over uncorrelated inner: all or nothing
                has = np.full(outer.nrows, inner.nrows > 0)
        else:
            li, ri = join_indices(co, ci) if n.on else _cross_indices(outer.nrows, inner.nrows)
            env = {}
            for c in outer.columns:
                env[c] = outer.cols[c][li]
            for c in inner.columns:
                if c not in env:
                    env[c] = inner.cols[c][ri]
            ok = eval_np(n.pred, env, n=len(li)).astype(bool)
            has = np.zeros(outer.nrows, dtype=bool)
            np.logical_or.at(has, li, ok)
        if isinstance(n, O.AntiJoin):
            has = ~has
        return outer.mask(has)

    def _groupby(self, n, rec) -> Table:
        t = rec(n.child)
        gid, first_idx, ng = group_codes([t.cols[k] for k in n.keys], t.nrows)
        cols: Dict[str, np.ndarray] = {}
        for k in n.keys:
            cols[k] = t.cols[k][first_idx]
        for out_c, agg in n.aggs.items():
            vals = None
            if agg.expr is not None:
                vals = np.asarray(eval_np(agg.expr, t.cols, n=t.nrows))
            cols[out_c] = _agg_reduce(agg.fn, vals, gid, ng)
        cols[RID] = np.arange(ng, dtype=np.int64)
        return Table(cols, t.dicts, None)

    def _pivot(self, n, rec) -> Table:
        t = rec(n.child)
        gid, first_idx, ng = group_codes([t.cols[n.index]], t.nrows)
        cols = {n.index: t.cols[n.index][first_idx]}
        for v in n.values:
            sel = t.cols[n.column] == (t.encode_value(n.column, v) if isinstance(v, str) else v)
            vals = np.where(sel, t.cols[n.value], 0)
            cnt = np.bincount(gid, weights=sel.astype(np.float64), minlength=ng)
            s = np.bincount(gid, weights=vals.astype(np.float64), minlength=ng)
            if n.agg == "sum":
                cols[n.out_col(v)] = s
            elif n.agg == "mean":
                cols[n.out_col(v)] = s / np.maximum(cnt, 1)
            elif n.agg == "count":
                cols[n.out_col(v)] = cnt
            else:
                raise ValueError(f"pivot agg {n.agg}")
        cols[RID] = np.arange(ng, dtype=np.int64)
        return Table(cols, t.dicts, None)

    def _window(self, n, rec) -> Table:
        t = rec(n.child)
        keys = [t.cols[c] for c in reversed(n.order_by)]
        order = np.lexsort(keys) if keys else np.arange(t.nrows)
        t = t.take(order)
        cols = dict(t.cols)
        cols["__pos__"] = np.arange(t.nrows, dtype=np.int64)
        w = n.size
        for out_c, agg in n.aggs.items():
            v = np.asarray(eval_np(agg.expr, t.cols, n=t.nrows), dtype=np.float64)
            c = np.cumsum(v)
            roll_sum = c.copy()
            if t.nrows > w:
                roll_sum[w:] -= c[:-w]
            if agg.fn == "sum":
                cols[out_c] = roll_sum
            elif agg.fn == "mean":
                denom = np.minimum(np.arange(t.nrows) + 1, w)
                cols[out_c] = roll_sum / denom
            else:
                # generic rolling agg (min/max): O(n*w) fallback, fine on host
                out = np.empty(t.nrows)
                for i in range(t.nrows):
                    lo = max(0, i - w + 1)
                    seg = v[lo : i + 1]
                    out[i] = seg.min() if agg.fn == "min" else seg.max()
                cols[out_c] = out
        return Table(cols, t.dicts, t.name)

    def _grouped_map(self, n, rec) -> Table:
        t = rec(n.child)
        gid, _, ng = group_codes([t.cols[k] for k in n.keys], t.nrows)
        env = dict(t.cols)
        for tmp, agg in n.group_aggs.items():
            vals = np.asarray(eval_np(agg.expr, t.cols, n=t.nrows)) if agg.expr is not None else None
            per_group = _agg_reduce(agg.fn, vals, gid, ng)
            env[tmp] = np.asarray(per_group)[gid]
        new = {c: np.asarray(eval_np(e, env, n=t.nrows)) for c, e in n.assigns.items()}
        return t.with_cols(new)

    def _scalar_sub(self, n, rec) -> Table:
        outer, inner = rec(n.child), rec(n.inner)
        vals = np.asarray(eval_np(n.agg.expr, inner.cols, n=inner.nrows)) if n.agg.expr is not None else None
        if not n.correlate:
            gid = np.zeros(inner.nrows, dtype=np.int64)
            scalar = _agg_reduce(n.agg.fn, vals, gid, 1)[0] * n.scale if inner.nrows else None
            if scalar is None:
                return outer.mask(np.zeros(outer.nrows, dtype=bool))
            lhs = eval_np(n.outer_expr, outer.cols, n=outer.nrows)
            m = _cmp(n.cmp, lhs, scalar)
            return outer.mask(m)
        co, ci = composite_codes(
            [outer.cols[a] for a, _ in n.correlate], [inner.cols[b] for _, b in n.correlate]
        )
        # aggregate inner per correlated key
        uniq, inv = np.unique(ci, return_inverse=True)
        per_key = _agg_reduce(n.agg.fn, vals, inv, len(uniq)) * n.scale
        pos = np.searchsorted(uniq, co)
        pos_c = np.clip(pos, 0, max(len(uniq) - 1, 0))
        exists = (len(uniq) > 0) & (uniq[pos_c] == co) if len(uniq) else np.zeros(len(co), bool)
        lhs = eval_np(n.outer_expr, outer.cols, n=outer.nrows)
        rhs = per_key[pos_c] if len(uniq) else np.zeros(len(co))
        m = exists & _cmp(n.cmp, lhs, rhs)
        return outer.mask(m)


def _nodes_by_id(plan: O.Node) -> Dict[int, O.Node]:
    out: Dict[int, O.Node] = {}

    def rec(n: O.Node) -> None:
        if n.id in out:
            return
        out[n.id] = n
        for c in n.children:
            rec(c)

    rec(plan)
    return out


def _cmp(op: str, a, b):
    return {
        "==": np.equal, "!=": np.not_equal, "<": np.less, "<=": np.less_equal,
        ">": np.greater, ">=": np.greater_equal,
    }[op](a, b)


def _descending(k: np.ndarray) -> np.ndarray:
    if np.issubdtype(k.dtype, np.number):
        return -k.astype(np.float64) if k.dtype.kind == "f" else -k.astype(np.int64)
    return -_rank_dense(k)


def _rank_dense(k: np.ndarray) -> np.ndarray:
    _, inv = np.unique(k, return_inverse=True)
    return inv.astype(np.int64)


def _cross_indices(nl: int, nr: int):
    li = np.repeat(np.arange(nl), nr)
    ri = np.tile(np.arange(nr), nl)
    return li, ri


def _null_for(dtype):
    if np.issubdtype(dtype, np.floating):
        return np.nan
    return -1
