"""Lazy-lineage baselines from paper §7.1.2.

* :class:`TraceBaseline`  — Cui & Widom-style lazy tracing: nothing is
  prepared at pipeline runtime; a lineage query re-executes the pipeline with
  per-operator backward tracing (we reuse the eager tracker at *query* time —
  same asymptotics: full recomputation per query).  Handles non-nested plans
  only (paper Table 4).
* :class:`RewriteBaseline` — GProM/Perm-style query rewrite: the provenance
  query propagates one row per (output row x witness combination) with
  provenance columns; the lineage query runs this augmented pipeline, filters
  ``t_o`` and projects the provenance columns.  No runtime overhead, heavy
  query cost — aggregation/scalar-subquery witnesses multiply rows, which is
  exactly the blow-up the paper measures (22 s average, 6 h outliers).  A
  witness budget stands in for the paper's 6-hour cutoff.
* :class:`PandaBaseline`   — logical-provenance attribute mappings + filters;
  single SELECT-block SPJA only.  Aggregations need an *augmentation* (the
  pre-aggregation state is materialized at runtime, sans row ids), and
  lineage retrieval filters source tables by mapped attribute values.

All three are host systems, as the paper's were: every pipeline run they
make uses the plain executor on the numpy scan backend.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from . import ops as O
from .eager import EagerExecutor, host_executor
from .executor import composite_codes, join_indices
from .expr import eval_np
from .lineage import LineageAnswer
from .table import RID, Table


class Unsupported(Exception):
    pass


NESTED = (O.SemiJoin, O.AntiJoin, O.FilterScalarSub)
NON_RELATIONAL = (O.Pivot, O.Unpivot, O.RowExpand, O.Window, O.GroupedMap)


def _prov_col(sid: int) -> str:
    return f"__prov_{sid}__"


# --------------------------------------------------------------------------- #
# Trace
# --------------------------------------------------------------------------- #


class TraceBaseline:
    name = "trace"

    def __init__(self, catalog: Dict[str, Table], plan: O.Node):
        self.catalog = catalog
        self.plan = plan

    def supports(self) -> bool:
        for n in O.walk(self.plan):
            if isinstance(n, NESTED) or isinstance(n, NON_RELATIONAL):
                return False
        return True

    def prepare(self):
        # lazy: no preparation, no overhead
        return host_executor(self.catalog).run(self.plan)

    def query(self, out: Table, row_idx: int) -> LineageAnswer:
        if not self.supports():
            raise Unsupported("Trace handles non-nested relational queries only")
        t0 = time.perf_counter()
        res = EagerExecutor(self.catalog).run(self.plan)  # full recomputation
        values = {c: out.cols[c][row_idx] for c in out.columns}
        m = np.ones(res.output.nrows, dtype=bool)
        for c, v in values.items():
            m &= res.output.cols[c] == v
        lin: Dict[str, np.ndarray] = {}
        for i in np.nonzero(m)[0]:
            for tab, rids in res.lineage[i].items():
                arr = np.fromiter(rids, dtype=np.int64)
                lin[tab] = np.union1d(lin[tab], arr) if tab in lin else np.unique(arr)
        return LineageAnswer(lin, time.perf_counter() - t0)


# --------------------------------------------------------------------------- #
# GProM-style rewrite
# --------------------------------------------------------------------------- #


class RewriteBaseline:
    name = "gprom"

    def __init__(self, catalog: Dict[str, Table], plan: O.Node, witness_budget: int = 30_000_000):
        self.catalog = catalog
        self.plan = plan
        self.budget = witness_budget

    def supports(self) -> bool:
        for n in O.walk(self.plan):
            if isinstance(n, NON_RELATIONAL):
                return False
        return True

    def prepare(self):
        return host_executor(self.catalog).run(self.plan)  # unmodified

    # -- provenance-propagating execution --------------------------------- #
    def _prov_exec(self, n: O.Node) -> Table:
        if isinstance(n, O.Source):
            t = self.catalog[n.table]
            return t.with_cols({_prov_col(n.id): t.rids()})

        if isinstance(n, O.Filter):
            t = self._prov_exec(n.child)
            m = eval_np(n.pred, t.cols, n=t.nrows).astype(bool)
            return t.mask(m)

        if isinstance(n, O.Project):
            t = self._prov_exec(n.child)
            keep = list(n.keep) + [c for c in t.cols if c.startswith("__prov_")]
            return t.project([c for c in keep if c in t.cols])

        if isinstance(n, O.RowTransform):
            t = self._prov_exec(n.child)
            new = {c: np.asarray(eval_np(e, t.cols, n=t.nrows)) for c, e in n.assigns.items()}
            return t.with_cols(new)

        if isinstance(n, O.Alias):
            t = self._prov_exec(n.child)
            ren = {c: n.prefix + c for c in t.columns if not c.startswith("__prov_")}
            return t.rename(ren)

        if isinstance(n, (O.InnerJoin, O.LeftOuterJoin)):
            l, r = self._prov_exec(n.left), self._prov_exec(n.right)
            self._check(l.nrows, r.nrows)
            tmp = host_executor({"__l": l, "__r": r}).run(
                type(n)(O.Source("__l"), O.Source("__r"), n.on, n.pred)
            ).output
            return tmp

        if isinstance(n, O.GroupBy):
            t = self._prov_exec(n.child)
            # provenance rewrite: every output row joins back to every member
            # of its group -> one witness row per input row, with the group's
            # aggregate values attached.  Aggregates must come from the CLEAN
            # (non-witness-multiplied) input, as in GProM's rewrite.
            clean = host_executor(self.catalog).run(n.child).output
            tmp = host_executor({"__t": clean}).run(
                O.GroupBy(O.Source("__t"), n.keys, n.aggs)
            ).output
            if n.keys:
                gl, gr = composite_codes(
                    [t.cols[k] for k in n.keys], [tmp.cols[k] for k in n.keys]
                )
                li, ri = join_indices(gl, gr)
            else:
                li = np.arange(t.nrows)
                ri = np.zeros(t.nrows, dtype=np.int64)
            cols = {}
            for k in n.keys:
                cols[k] = tmp.cols[k][ri]
            for a in n.aggs:
                cols[a] = tmp.cols[a][ri]
            for c in t.cols:
                if c.startswith("__prov_"):
                    cols[c] = t.cols[c][li]
            cols[RID] = np.arange(len(li), dtype=np.int64)
            return Table(cols, t.dicts)

        if isinstance(n, O.Sort):
            t = self._prov_exec(n.child)
            tmp = host_executor({"__t": t}).run(O.Sort(O.Source("__t"), n.by, n.limit)).output
            return tmp

        if isinstance(n, O.Union):
            parts = [self._prov_exec(p) for p in n.parts]
            # align prov columns
            all_prov = sorted({c for p in parts for c in p.cols if c.startswith("__prov_")})
            aligned = []
            for p in parts:
                missing = {c: np.full(p.nrows, -1, dtype=np.int64) for c in all_prov if c not in p.cols}
                aligned.append(p.with_cols(missing))
            from .table import concat_tables

            return concat_tables(aligned)

        if isinstance(n, O.Intersect):
            l, r = self._prov_exec(n.left), self._prov_exec(n.right)
            cols = [c for c in l.columns if not c.startswith("__prov_")]
            cl, cr = composite_codes([l.cols[c] for c in cols], [r.cols[c] for c in cols])
            li, ri = join_indices(cl, cr)
            out = {c: l.cols[c][li] for c in l.cols}
            for c in r.cols:
                if c.startswith("__prov_"):
                    out[c] = r.cols[c][ri]
            out[RID] = np.arange(len(li), dtype=np.int64)
            return Table(out, l.dicts)

        if isinstance(n, O.SemiJoin):
            o, i = self._prov_exec(n.outer), self._prov_exec(n.inner)
            self._check(o.nrows, i.nrows)
            # witnesses: outer x matching inner rows
            co, ci = composite_codes([o.cols[a] for a, _ in n.on], [i.cols[b] for _, b in n.on])
            li, ri = join_indices(co, ci)
            if n.pred is not None and len(li):
                env = {c: o.cols[c][li] for c in o.columns}
                for c in i.columns:
                    if c not in env:
                        env[c] = i.cols[c][ri]
                ok = eval_np(n.pred, env, n=len(li)).astype(bool)
                li, ri = li[ok], ri[ok]
            cols = {c: o.cols[c][li] for c in o.cols}
            for c in i.cols:
                if c.startswith("__prov_"):
                    cols[c] = i.cols[c][ri]
            cols[RID] = np.arange(len(li), dtype=np.int64)
            return Table(cols, o.dicts)

        if isinstance(n, O.AntiJoin):
            o, i = self._prov_exec(n.outer), self._prov_exec(n.inner)
            tmp = host_executor({"__o": o, "__i": i}).run(
                O.AntiJoin(O.Source("__o"), O.Source("__i"), n.on, n.pred)
            ).output
            return tmp

        if isinstance(n, O.FilterScalarSub):
            o, i = self._prov_exec(n.child), self._prov_exec(n.inner)
            tmp = host_executor({"__o": o, "__i": i}).run(
                O.FilterScalarSub(
                    O.Source("__o"), O.Source("__i"), n.correlate, n.agg, n.cmp,
                    n.outer_expr, n.scale,
                )
            ).output
            if not n.correlate:
                self._check(tmp.nrows, i.nrows, product=True)
                li = np.repeat(np.arange(tmp.nrows), i.nrows)
                ri = np.tile(np.arange(i.nrows), tmp.nrows)
            else:
                co, ci = composite_codes(
                    [tmp.cols[a] for a, _ in n.correlate], [i.cols[b] for _, b in n.correlate]
                )
                li, ri = join_indices(co, ci)
            cols = {c: tmp.cols[c][li] for c in tmp.cols}
            for c in i.cols:
                if c.startswith("__prov_"):
                    cols[c] = i.cols[c][ri]
            cols[RID] = np.arange(len(li), dtype=np.int64)
            return Table(cols, tmp.dicts)

        raise Unsupported(f"GProM rewrite: unsupported operator {type(n).__name__}")

    def _check(self, a: int, b: int, product: bool = False):
        est = a * b if product else a + b
        if est > self.budget:
            raise Unsupported(f"provenance witness budget exceeded ({est} rows)")

    def query(self, out: Table, row_idx: int) -> LineageAnswer:
        if not self.supports():
            raise Unsupported("GProM handles relational operators only")
        t0 = time.perf_counter()
        prov = self._prov_exec(self.plan)
        values = {c: out.cols[c][row_idx] for c in out.columns}
        m = np.ones(prov.nrows, dtype=bool)
        for c, v in values.items():
            if c in prov.cols:
                col = prov.cols[c]
                if col.dtype.kind == "f":
                    m &= np.isclose(col, float(v), rtol=1e-9, atol=1e-12)
                else:
                    m &= col == v
        lin: Dict[str, np.ndarray] = {}
        src_of = {n.id: n.table for n in O.walk(self.plan) if isinstance(n, O.Source)}
        for c in prov.cols:
            if not c.startswith("__prov_"):
                continue
            sid = int(c[len("__prov_") : -2])
            tab = src_of.get(sid)
            if tab is None:
                continue
            rids = prov.cols[c][m]
            rids = np.unique(rids[rids >= 0])
            lin[tab] = np.union1d(lin[tab], rids) if tab in lin else rids
        return LineageAnswer(lin, time.perf_counter() - t0)


# --------------------------------------------------------------------------- #
# Panda-style
# --------------------------------------------------------------------------- #


class PandaBaseline:
    name = "panda"

    def __init__(self, catalog: Dict[str, Table], plan: O.Node):
        self.catalog = catalog
        self.plan = plan
        self.augmentation: Optional[Table] = None
        self.prepare_overhead = 0.0

    def supports(self) -> bool:
        """Single SELECT block: filters/joins/transform/project + at most one
        GroupBy at the top (before Sort).  Panda's provenance-specification
        language has no CASE expressions, computed date parts, self-join
        aliases or disjunctive filters (paper Table 4: only Q1/3/5/6/10)."""
        from .expr import IfThenElse as _ITE, UnaryOp as _U, BinOp as _B

        def expr_ok(e) -> bool:
            if isinstance(e, _ITE):
                return False
            if isinstance(e, _U) and e.op == "year":
                return False
            if isinstance(e, _B):
                if e.op == "or":
                    return False
                return expr_ok(e.left) and expr_ok(e.right)
            return True

        seen_groupby = 0
        for n in O.walk(self.plan):
            if isinstance(n, NESTED) or isinstance(n, NON_RELATIONAL):
                return False
            if isinstance(n, O.Alias):
                return False
            if isinstance(n, O.Filter) and not expr_ok(n.pred):
                return False
            if isinstance(n, O.RowTransform) and not all(expr_ok(e) for e in n.assigns.values()):
                return False
            if isinstance(n, O.GroupBy):
                if not all(a.expr is None or expr_ok(a.expr) for a in n.aggs.values()):
                    return False
                seen_groupby += 1
        if seen_groupby > 1:
            return False
        if seen_groupby == 1:
            # the GroupBy must sit on the main path with only Sort/Project above
            cur = self.plan
            while cur is not None and not isinstance(cur, O.GroupBy):
                if not isinstance(cur, (O.Sort, O.Project)):
                    return False
                cur = cur.main_child
            if not isinstance(cur, O.GroupBy):
                return False
        return True

    def prepare(self):
        """Runs the pipeline; if aggregation present, stores the augmentation
        (pre-aggregation state, attribute columns only — no row ids)."""
        if not self.supports():
            raise Unsupported("Panda handles single SELECT blocks only")
        t0 = time.perf_counter()
        res = host_executor(self.catalog).run(self.plan)
        gb = self._find_groupby()
        if gb is not None:
            pre = host_executor(self.catalog).run(gb.child).output
            keep = [c for c in pre.columns]
            self.augmentation = pre.project(keep)
        self.prepare_overhead = time.perf_counter() - t0 - res.seconds
        return res

    def _find_groupby(self) -> Optional[O.GroupBy]:
        cur = self.plan
        while cur is not None:
            if isinstance(cur, O.GroupBy):
                return cur
            cur = cur.main_child
        return None

    def storage_overhead(self) -> int:
        return self.augmentation.nbytes() if self.augmentation is not None else 0

    def query(self, out: Table, row_idx: int) -> LineageAnswer:
        t0 = time.perf_counter()
        values = {c: out.cols[c][row_idx] for c in out.columns}
        gb = self._find_groupby()
        if gb is not None and self.augmentation is not None:
            aug = self.augmentation
            m = np.ones(aug.nrows, dtype=bool)
            for k in gb.keys:
                if k in values and k in aug.cols:
                    m &= aug.cols[k] == values[k]
            witness = aug.mask(m)
        else:
            witness = None
        # attribute mapping: filter each source by the mapped attribute values
        lin: Dict[str, np.ndarray] = {}
        for src in O.sources(self.plan):
            t = self.catalog[src.table]
            m = np.ones(t.nrows, dtype=bool)
            any_attr = False
            ref = witness if witness is not None else None
            for c in t.columns:
                if ref is not None and c in ref.cols:
                    any_attr = True
                    m &= np.isin(t.cols[c], np.unique(ref.cols[c]))
                elif ref is None and c in values:
                    any_attr = True
                    v = values[c]
                    col = t.cols[c]
                    if col.dtype.kind == "f":
                        m &= np.isclose(col, float(v))
                    else:
                        m &= col == v
            if not any_attr:
                m = np.zeros(t.nrows, dtype=bool)
            rids = t.rids()[m]
            lin[src.table] = (
                np.union1d(lin[src.table], rids) if src.table in lin else np.unique(rids)
            )
        return LineageAnswer(lin, time.perf_counter() - t0)
