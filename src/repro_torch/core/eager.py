"""Eager row-level lineage tracking (baseline AND test oracle).

Executes a plan while propagating, for every intermediate row, the exact set
of source-table row-ids that produced it (Definition 3.1/3.2 semantics:
groups/windows contribute whole member sets; semi-joins contribute matching
inner rows; anti-joins contribute no inner rows).  This is the "extra lineage
column" baseline of paper §7.1.2 and also stands in for SMOKE-style eager
tracking (§7.4): tracking cost is paid at pipeline runtime, lineage lookup is
then O(1).

Representation: per output row, ``dict[source_name -> frozenset[row_id]]``.
Intentionally simple — its overhead versus PredTrace *is* the experiment.
It is host code throughout: filters evaluate with ``eval_np`` and the plain
executor steps it borrows run on the numpy scan backend, so the oracle
shares no device code with the path it checks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Sequence, Tuple

import numpy as np

from . import ops as O
from .executor import (
    Executor,
    _cross_indices,
    composite_codes,
    group_codes,
    join_indices,
)
from .expr import eval_np
from .scan import ScanEngine
from .table import Table, concat_tables

Lineage = Dict[str, FrozenSet[int]]


def host_executor(catalog: Dict[str, Table]) -> Executor:
    """The plain executor on the host (numpy scan backend)."""
    return Executor(catalog, scan_engine=ScanEngine("numpy"))


def _merge(a: Lineage, b: Lineage) -> Lineage:
    out = dict(a)
    for k, v in b.items():
        out[k] = out[k] | v if k in out else v
    return out


def _union_all(items: Sequence[Lineage]) -> Lineage:
    out: Dict[str, FrozenSet[int]] = {}
    for it in items:
        for k, v in it.items():
            out[k] = out[k] | v if k in out else v
    return out


@dataclass
class EagerResult:
    output: Table
    lineage: List[Lineage]  # parallel to output rows
    seconds: float = 0.0


class EagerExecutor:
    """Forward execution with lineage columns."""

    def __init__(self, catalog: Dict[str, Table]):
        self.catalog = catalog

    def run(self, plan: O.Node) -> EagerResult:
        import time

        t0 = time.perf_counter()
        table, lin = self._exec(plan)
        return EagerResult(table, lin, time.perf_counter() - t0)

    # ------------------------------------------------------------------ #
    def _exec(self, n: O.Node) -> Tuple[Table, List[Lineage]]:
        if isinstance(n, O.Source):
            t = self.catalog[n.table]
            lin = [{n.table: frozenset([int(r)])} for r in t.rids()]
            return t, lin

        if isinstance(n, O.Filter):
            t, lin = self._exec(n.child)
            m = eval_np(n.pred, t.cols, n=t.nrows).astype(bool)
            idx = np.nonzero(m)[0]
            return t.mask(m), [lin[i] for i in idx]

        if isinstance(n, O.Project):
            t, lin = self._exec(n.child)
            return t.project(n.keep), lin

        if isinstance(n, O.RowTransform):
            t, lin = self._exec(n.child)
            new = {c: np.asarray(eval_np(e, t.cols, n=t.nrows)) for c, e in n.assigns.items()}
            return t.with_cols(new), lin

        if isinstance(n, O.Alias):
            t, lin = self._exec(n.child)
            return t.prefix(n.prefix), lin

        if isinstance(n, (O.InnerJoin, O.LeftOuterJoin)):
            return self._join(n)

        if isinstance(n, (O.SemiJoin, O.AntiJoin)):
            return self._semi(n)

        if isinstance(n, O.GroupBy):
            t, lin = self._exec(n.child)
            gid, first_idx, ng = group_codes([t.cols[k] for k in n.keys], t.nrows)
            # reuse the plain executor's groupby on the computed child table
            tmp = _exec_groupby(n, t)
            glin: List[Lineage] = [dict() for _ in range(ng)]
            for i, g in enumerate(gid):
                glin[g] = _merge(glin[g], lin[i])
            return tmp, glin

        if isinstance(n, O.Sort):
            t, lin = self._exec(n.child)
            keys = [t.cols[c] for c, _ in reversed(n.by)]
            asc = [a for _, a in reversed(n.by)]
            from .executor import _descending

            keys = [k if a else _descending(k) for k, a in zip(keys, asc)]
            order = np.lexsort(keys) if keys else np.arange(t.nrows)
            out_t = t.take(order)
            out_l = [lin[i] for i in order]
            if n.limit is not None:
                out_t = out_t.head(n.limit)
                out_l = out_l[: n.limit]
            return out_t, out_l

        if isinstance(n, O.Union):
            ts, ls = zip(*[self._exec(p) for p in n.parts])
            return concat_tables(list(ts)), [x for l in ls for x in l]

        if isinstance(n, O.Intersect):
            (lt, ll), (rt, rl) = self._exec(n.left), self._exec(n.right)
            cols = lt.columns
            cl, cr = composite_codes([lt.cols[c] for c in cols], [rt.cols[c] for c in cols])
            m = np.isin(cl, cr)
            idx = np.nonzero(m)[0]
            # matching right rows contribute too
            out_l = []
            for i in idx:
                mine = ll[i]
                match = np.nonzero(cr == cl[i])[0]
                mine = _merge(mine, _union_all([rl[j] for j in match]))
                out_l.append(mine)
            return lt.mask(m), out_l

        if isinstance(n, O.Pivot):
            t, lin = self._exec(n.child)
            tmp = host_executor({"__t": t}).run(O.Pivot(O.Source("__t"), n.index, n.column, n.value, n.agg, n.values)).output
            gid, _, ng = group_codes([t.cols[n.index]], t.nrows)
            glin: List[Lineage] = [dict() for _ in range(ng)]
            for i, g in enumerate(gid):
                glin[g] = _merge(glin[g], lin[i])
            return tmp, glin

        if isinstance(n, O.Unpivot):
            t, lin = self._exec(n.child)
            tmp = host_executor({"__t": t}).run(
                O.Unpivot(O.Source("__t"), n.index_cols, n.value_cols, n.var_name, n.value_name)
            ).output
            return tmp, lin * len(n.value_cols)

        if isinstance(n, O.RowExpand):
            t, lin = self._exec(n.child)
            tmp = host_executor({"__t": t}).run(O.RowExpand(O.Source("__t"), n.variants)).output
            return tmp, lin * len(n.variants)

        if isinstance(n, O.Window):
            t, lin = self._exec(n.child)
            tmp = host_executor({"__t": t}).run(
                O.Window(O.Source("__t"), n.order_by, n.size, n.aggs)
            ).output
            keys = [t.cols[c] for c in reversed(n.order_by)]
            order = np.lexsort(keys) if keys else np.arange(t.nrows)
            out_l = []
            for pos in range(t.nrows):
                lo = max(0, pos - n.size + 1)
                out_l.append(_union_all([lin[order[j]] for j in range(lo, pos + 1)]))
            return tmp, out_l

        if isinstance(n, O.GroupedMap):
            t, lin = self._exec(n.child)
            tmp = host_executor({"__t": t}).run(
                O.GroupedMap(O.Source("__t"), n.keys, n.group_aggs, n.assigns)
            ).output
            gid, _, ng = group_codes([t.cols[k] for k in n.keys], t.nrows)
            glin: List[Lineage] = [dict() for _ in range(ng)]
            for i, g in enumerate(gid):
                glin[g] = _merge(glin[g], lin[i])
            return tmp, [_merge(lin[i], glin[gid[i]]) for i in range(t.nrows)]

        if isinstance(n, O.FilterScalarSub):
            return self._scalar_sub(n)

        if isinstance(n, O.MapUDF):
            # row-preserving: lineage passes through unchanged
            t, lin = self._exec(n.child)
            from .executor import map_udf_cols

            return t.with_cols(map_udf_cols(n, t)), lin

        if isinstance(n, O.FilterUDF):
            t, lin = self._exec(n.child)
            m = np.asarray(eval_np(n.pred_expr(), t.cols, n=t.nrows), bool)
            idx = np.nonzero(m)[0]
            return t.mask(m), [lin[i] for i in idx]

        if isinstance(n, O.ExpandUDF):
            t, lin = self._exec(n.child)
            from .executor import expand_udf_rows

            parent_idx, outs = expand_udf_rows(n, t)
            tmp = t.take(parent_idx).with_cols(outs)
            return tmp, [lin[i] for i in parent_idx]

        if isinstance(n, O.OpaqueUDF):
            # no row correspondence: every output row depends on the whole
            # input (the paper's well-defined lineage for opaque operators)
            t, lin = self._exec(n.child)
            from .executor import opaque_udf_table

            tmp = opaque_udf_table(n, t)
            all_in = _union_all(lin)
            return tmp, [dict(all_in) for _ in range(tmp.nrows)]

        raise TypeError(f"eager: unknown node {type(n)}")

    # ------------------------------------------------------------------ #
    def _join(self, n) -> Tuple[Table, List[Lineage]]:
        (lt, ll), (rt, rl) = self._exec(n.left), self._exec(n.right)
        cl, cr = composite_codes([lt.cols[a] for a, _ in n.on], [rt.cols[b] for _, b in n.on])
        li, ri = join_indices(cl, cr)
        if n.pred is not None:
            env = {c: lt.cols[c][li] for c in lt.columns}
            for c in rt.columns:
                if c not in env:
                    env[c] = rt.cols[c][ri]
            keep = eval_np(n.pred, env, n=len(li)).astype(bool)
            li, ri = li[keep], ri[keep]
        pairs = [(int(a), int(b)) for a, b in zip(li, ri)]
        if isinstance(n, O.LeftOuterJoin):
            matched = np.zeros(lt.nrows, dtype=bool)
            matched[li] = True
            miss = np.nonzero(~matched)[0]
            li = np.concatenate([li, miss])
            ri = np.concatenate([ri, np.full(len(miss), -1, dtype=ri.dtype)])
            pairs += [(int(i), -1) for i in miss]
        # reuse plain executor to build the joined table
        plain = host_executor({"__l": lt, "__r": rt})
        cls = O.LeftOuterJoin if isinstance(n, O.LeftOuterJoin) else O.InnerJoin
        tmp = plain.run(cls(O.Source("__l"), O.Source("__r"), n.on, n.pred)).output
        lin = [
            _merge(ll[a], rl[b]) if b >= 0 else dict(ll[a])
            for a, b in pairs
        ]
        return tmp, lin

    def _semi(self, n) -> Tuple[Table, List[Lineage]]:
        (ot, ol), (it, il) = self._exec(n.outer), self._exec(n.inner)
        co, ci = composite_codes([ot.cols[a] for a, _ in n.on], [it.cols[b] for _, b in n.on])
        if n.on:
            li, ri = join_indices(co, ci)
        else:
            li, ri = _cross_indices(ot.nrows, it.nrows)
        if n.pred is not None and len(li):
            env = {c: ot.cols[c][li] for c in ot.columns}
            for c in it.columns:
                if c not in env:
                    env[c] = it.cols[c][ri]
            ok = eval_np(n.pred, env, n=len(li)).astype(bool)
            li, ri = li[ok], ri[ok]
        has = np.zeros(ot.nrows, dtype=bool)
        has[li] = True
        if isinstance(n, O.AntiJoin):
            keep = ~has
            idx = np.nonzero(keep)[0]
            # inner contributes nothing (paper Table 2: empty set)
            return ot.mask(keep), [dict(ol[i]) for i in idx]
        keep = has
        idx = np.nonzero(keep)[0]
        # matched inner rows contribute (paper's Q4 semantics)
        inner_by_outer: Dict[int, List[Lineage]] = {}
        for a, b in zip(li, ri):
            inner_by_outer.setdefault(int(a), []).append(il[int(b)])
        out_l = []
        for i in idx:
            l = ol[i]
            if int(i) in inner_by_outer:
                l = _merge(l, _union_all(inner_by_outer[int(i)]))
            out_l.append(l)
        return ot.mask(keep), out_l

    def _scalar_sub(self, n) -> Tuple[Table, List[Lineage]]:
        (ot, ol), (it, il) = self._exec(n.child), self._exec(n.inner)
        plain = host_executor({"__o": ot, "__i": it})
        tmp = plain.run(
            O.FilterScalarSub(
                O.Source("__o"), O.Source("__i"), n.correlate, n.agg, n.cmp, n.outer_expr, n.scale
            )
        ).output
        if not n.correlate:
            all_inner = _union_all(il) if il else {}
            keep_rids = set(tmp.rids().tolist())
            out_l = [
                _merge(ol[i], all_inner)
                for i in range(ot.nrows)
                if int(ot.rids()[i]) in keep_rids
            ]
            return tmp, out_l
        co, ci = composite_codes(
            [ot.cols[a] for a, _ in n.correlate], [it.cols[b] for _, b in n.correlate]
        )
        group_lin: Dict[int, Lineage] = {}
        for j, code in enumerate(ci):
            group_lin[int(code)] = _merge(group_lin.get(int(code), {}), il[j])
        keep_rids = set(tmp.rids().tolist())
        out_l = []
        for i in range(ot.nrows):
            if int(ot.rids()[i]) not in keep_rids:
                continue
            out_l.append(_merge(ol[i], group_lin.get(int(co[i]), {})))
        return tmp, out_l


def _exec_groupby(n: O.GroupBy, t: Table) -> Table:
    return host_executor({"__t": t}).run(
        O.GroupBy(O.Source("__t"), n.keys, n.aggs)
    ).output


# --------------------------------------------------------------------------- #
# oracle API for tests
# --------------------------------------------------------------------------- #


def oracle_lineage_for_values(
    catalog: Dict[str, Table], plan: O.Node, values: Dict[str, object]
) -> Dict[str, FrozenSet[int]]:
    """Ground-truth lineage under set semantics: union of eager lineage over
    all output rows whose columns match ``values``."""
    res = EagerExecutor(catalog).run(plan)
    t = res.output
    m = np.ones(t.nrows, dtype=bool)
    for c, v in values.items():
        v_enc = t.encode_value(c, v) if isinstance(v, str) else v
        col = t.cols[c]
        if isinstance(v_enc, float) or (hasattr(col, "dtype") and col.dtype.kind == "f"):
            m &= np.isclose(col.astype(np.float64), float(v_enc), rtol=1e-9, atol=1e-9)
        else:
            m &= col == v_enc
    idx = np.nonzero(m)[0]
    return _union_all([res.lineage[i] for i in idx])
