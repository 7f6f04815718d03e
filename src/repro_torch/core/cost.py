"""Cost-based scan/plan selection: the model behind every dispatch decision.

The engine has many ways to answer one lineage query — precise scan vs.
iterative inference vs. superset, in-situ vs. decode-then-scan vs. device
dispatch, pruned vs. full serial scan vs. fused-kernel batch.  Every one of
those call sites in ``scan.py`` / ``store.py`` / ``plan.py`` consults a
:class:`CostModel`:

* each *route* (``serial``, ``pruned``, ``parallel``, ``device``, ...) carries
  a linear cost model ``seconds = a + b * work`` where ``work`` is the
  rows x atoms (x bindings) product of the scan,
* the seed parameters are derived from ``core/dispatch.py``'s *measured*
  cutovers so that, before any observation, the model reproduces the
  measured crossovers of this host,
* every executed choice is timed and fed back via :meth:`CostModel.observe`
  (EWMA on the marginal cost), so the model self-corrects when the seeds
  disagree with reality — and when a route's estimates stay off by more than
  :data:`FLAG_RATIO` over a window, the model flags it and asks ``dispatch``
  to drop (and later re-measure) the offending probe.

``explain()`` support: a thread-local :class:`PlanRecorder` captures every
:class:`Decision` (considered candidates with estimated cost, chosen route,
actual measured seconds) made while it is active; ``PredTrace.explain``
assembles them into a :class:`PlanReport` with a stable dict/JSON form.

The formulas and calibration knobs are those of the reference package
(its ``docs/cost_model.md`` and ``docs/explain.md``), except the device
route's seed ratio, which is measured on the card.
"""

from __future__ import annotations

import json
import math
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "CostModel", "Choice", "Decision", "PlanRecorder", "PlanReport",
    "active_recorder", "default_cost_model", "prog_atoms",
    "SCHEMA_VERSION",
]

# stable schema tag for PlanReport.to_dict(); bump on breaking field changes
SCHEMA_VERSION = 1

# ---------------------------------------------------------------------------
# calibration constants (documented in docs/cost_model.md)
# ---------------------------------------------------------------------------

# fixed per-scan overhead charged to every route (python dispatch, cache
# lookups) before any per-row work
BASE_OVERHEAD_S = 2e-6
# seeded marginal-cost ratios vs. the serial numpy scan (b_route / b_serial).
# PRUNED_RATIO = 8/7 makes the seeded pruned-vs-serial crossover land exactly
# on the old MIN_SKIP_FRACTION = 1/8 rule: pruned wins iff the skipped rows
# exceed ~1/8 of the table (plus one partition's floor, charged as work).
PRUNED_RATIO = 8.0 / 7.0
# device throughput seed: marginal seconds per row x atom of the CUDA
# kernel's launch path (cached slab, per-launch operand upload, mask
# readback) over the numpy serial scan's (``dispatch.host_row_cost``):
# 2.41e-11 s / 1.10e-9 s = 0.0219, measured by ``chip_smoke.py`` (its
# "device_ratio" line) on an NVIDIA H100 80GB HBM3 at a 700 W power limit
DEVICE_RATIO_CUDA = 0.022
# in-situ code-space compares move less memory than decoded int64 compares
INSITU_RATIO = 0.5
# fused membership: the in-grid binary search costs log2(|set|) compares per
# row but replaces numpy's sort+searchsorted isin (which re-walks the column
# per set), so its seeded marginal cost still undercuts the host probe
MEMBER_RATIO = 0.5
# run-space RLE scans touch one lane element per *run* and pay a final
# np.repeat expansion; charged per row, that is far below a serial scan
RLE_RATIO = 0.25

# online refinement: EWMA weight for the learned marginal cost, the minimum
# observations before the learned slope overrides the seed, and the work
# floor below which a timing is overhead-dominated noise (never learned from)
ALPHA = 0.3
MIN_OBS = 3
WORK_FLOOR = 2048

# feedback loop: when the median est/actual ratio over a FLAG_WINDOW-deep
# route history leaves [1/FLAG_RATIO, FLAG_RATIO], the route is flagged and
# the matching dispatch probe is invalidated (re-measured on next use)
FLAG_RATIO = 3.0
FLAG_WINDOW = 8

# default seed ratios per route, applied when a call site does not pass its
# own (cutovers always come from the call site's measured probe)
_ROUTE_RATIO = {
    "serial": 1.0,
    "pruned": PRUNED_RATIO,
    "decode": 1.0,
    "insitu": INSITU_RATIO,
    "insitu_heavy": INSITU_RATIO,
    "batch_pivot": 1.0,
    "device_member": MEMBER_RATIO,
    "device_float": DEVICE_RATIO_CUDA,
    "insitu_rle": RLE_RATIO,
}

# route -> dispatch probe family invalidated when the route's estimates
# persistently disagree with observed actuals
_DISPATCH_KIND = {
    "device": "device",
    "device_batch": "device",
    "device_insitu": "device",
    "device_member": "member",
    "device_float": "device",
    "insitu": "insitu",
    "insitu_heavy": "insitu",
    "insitu_rle": "rle",
    "decode": "insitu",
}


def prog_atoms(prog) -> int:
    """Work-unit atom count of a compiled ``AtomProgram``: comparison and
    membership atoms plus one unit per residual expression, floored at 1."""
    n = len(prog.cmp_atoms) + len(prog.isin_atoms)
    if prog.residual_static is not None:
        n += 1
    if prog.residual_dynamic is not None:
        n += 1
    return max(n, 1)


# ---------------------------------------------------------------------------
# per-route linear model
# ---------------------------------------------------------------------------


@dataclass
class _Lin:
    """``seconds = a + slope() * work`` for one route.

    ``b`` is the seeded marginal cost (derived from a measured dispatch
    cutover); ``b_obs`` is the EWMA of observed marginal costs and takes over
    once ``n_obs >= min_obs`` — injecting a few observations is exactly how
    tests (and reality) flip a seeded choice."""

    a: float                  # fixed overhead, seconds
    b: float                  # seeded marginal cost, seconds per unit work
    b_obs: float = 0.0        # EWMA-learned marginal cost
    n_obs: int = 0            # observations that updated b_obs
    chosen: int = 0           # times this route was picked / executed
    min_obs: int = MIN_OBS    # observations before b_obs overrides b

    def slope(self) -> float:
        return self.b_obs if self.n_obs >= self.min_obs else self.b

    def est(self, work: float) -> float:
        return self.a + self.slope() * max(work, 0.0)

    def snapshot(self) -> Dict[str, object]:
        return {
            "a_s": self.a, "b_seed_s": self.b, "b_obs_s": self.b_obs,
            "n_obs": self.n_obs, "chosen": self.chosen,
            "learned": self.n_obs >= self.min_obs,
        }


# ---------------------------------------------------------------------------
# decisions + thread-local recorder
# ---------------------------------------------------------------------------


@dataclass
class Decision:
    """One recorded dispatch decision: the candidates considered (with their
    estimated cost), the route chosen, and — once the scan ran — the actual
    measured seconds.  ``fallback_from`` is set when the chosen candidate
    turned out inviable at execution time (e.g. a device in-situ scan whose
    program left the kernel fragment) and a cheaper-next route ran instead."""

    site: str                       # e.g. "scan:lineitem", "store:7"
    chosen: str                     # route that ran
    est_s: float                    # estimate of the chosen route
    candidates: List[Dict[str, object]]  # [{route, work, est_s}, ...]
    actual_s: Optional[float] = None
    fallback_from: Optional[str] = None
    meta: Dict[str, object] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, object]:
        return {
            "site": self.site,
            "chosen": self.chosen,
            "est_s": float(self.est_s),
            "actual_s": None if self.actual_s is None else float(self.actual_s),
            "fallback_from": self.fallback_from,
            "candidates": [
                {"route": c["route"], "work": float(c["work"]),
                 "est_s": float(c["est_s"])}
                for c in self.candidates
            ],
            "meta": dict(self.meta),
        }


_TL = threading.local()


def active_recorder() -> Optional["PlanRecorder"]:
    """The thread's active :class:`PlanRecorder`, or None (the common case —
    recording costs nothing unless ``explain()`` installed a recorder)."""
    return getattr(_TL, "recorder", None)


class PlanRecorder:
    """Context manager collecting every :class:`Decision` the current thread
    makes while it is active.  ``PredTrace.explain`` runs the query under one
    of these and turns the collected decisions into a :class:`PlanReport`."""

    def __init__(self):
        self.decisions: List[Decision] = []

    def add(self, dec: Decision) -> None:
        self.decisions.append(dec)

    def __enter__(self) -> "PlanRecorder":
        self._prev = getattr(_TL, "recorder", None)
        _TL.recorder = self
        return self

    def __exit__(self, *exc) -> None:
        _TL.recorder = self._prev
        self._prev = None


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class Choice:
    """Return value of :meth:`CostModel.choose`: the picked route plus the
    full ranking, and a :meth:`done` hook the call site invokes with the
    measured seconds (feeding the observation loop and stamping the recorded
    decision's ``actual_s``)."""

    __slots__ = ("model", "route", "work", "est", "ranked", "decision")

    def __init__(self, model: "CostModel", route: str, work: float,
                 est: float, ranked: List[Tuple[float, str, float]],
                 decision: Optional[Decision]):
        self.model = model
        self.route = route
        self.work = work
        self.est = est
        self.ranked = ranked          # [(est_s, route, work)] cheapest-first
        self.decision = decision

    def done(self, seconds: float, route: Optional[str] = None,
             work: Optional[float] = None, observe: bool = True) -> None:
        """Report the measured wall time of the executed route.  Pass
        ``route=`` when execution fell back to a different candidate than the
        one originally chosen (the decision records the fallback).  Pass
        ``observe=False`` when the note exists only for plan visibility and
        the executed path already reports its own timing — feeding the same
        wall time twice under different work scales would corrupt the
        per-route slopes."""
        r = self.route if route is None else route
        w = self.work if work is None else work
        est = self.est
        if route is not None and route != self.route:
            est = next((e for e, rr, _ in self.ranked if rr == route), est)
            if self.decision is not None:
                self.decision.fallback_from = self.decision.chosen
                self.decision.chosen = route
                self.decision.est_s = est
        if self.decision is not None:
            self.decision.actual_s = seconds
        if observe:
            self.model.observe(r, w, seconds, est=est)


class CostModel:
    """Per-engine scan cost model: seeded from measured dispatch cutovers,
    refined online from observed actuals, and the single authority every
    dispatch heuristic in the scan stack consults.

    Thread-safe: one model is shared by all scans of one ``ScanEngine``
    (every query thread and the executor)."""

    def __init__(self):
        self._lins: Dict[str, _Lin] = {}
        self._lock = threading.Lock()
        self._errors: Dict[str, deque] = {}
        self._flags: List[Dict[str, object]] = []
        self._err_recent: deque = deque(maxlen=512)
        self._n_observed = 0
        self._row_cost: Optional[float] = None

    # -- seeding ------------------------------------------------------- #
    def _host_row_cost(self) -> float:
        if self._row_cost is None:
            from .dispatch import host_row_cost

            self._row_cost = host_row_cost()
        return self._row_cost

    def lin(self, route: str, cutover: Optional[float] = None,
            ratio: Optional[float] = None, confidence: float = 1.0) -> _Lin:
        """The route's linear model, lazily seeded on first use.

        ``ratio`` is the seeded marginal cost relative to the serial host
        scan; ``cutover`` (a measured work-product crossover from
        ``core/dispatch.py``) sets the overhead so that, at seed time,
        ``est(route, w) < est(serial, w)`` exactly when ``w > cutover`` —
        seeded decisions reproduce the measured-heuristic decisions.  A
        ``confidence < 1`` probe (one that has been invalidated before)
        hands over to learned observations after a single sample."""
        ln = self._lins.get(route)
        if ln is not None:
            return ln
        with self._lock:
            ln = self._lins.get(route)
            if ln is not None:
                return ln
            rc = self._host_row_cost()
            if ratio is None:
                ratio = _ROUTE_RATIO.get(route, 1.0)
            b = rc * ratio
            a = BASE_OVERHEAD_S
            if cutover is not None and rc > b:
                a += (rc - b) * float(min(cutover, float(1 << 40)))
            ln = _Lin(a=a, b=b)
            if confidence < 1.0:
                ln.min_obs = 1
            self._lins[route] = ln
            return ln

    # -- estimation / selection ---------------------------------------- #
    def estimate(self, route: str, work: float, **seed_kw) -> float:
        """Estimated seconds for ``work`` units (rows x atoms x bindings) on
        ``route``; seeds the route first if it has never been used."""
        return self.lin(route, **seed_kw).est(work)

    def prefer(self, route: str, work: float, **seed_kw) -> bool:
        """Two-way consult: does ``route`` beat the serial host scan at this
        work size?  (The cutover-backed replacement for every old
        ``work >= threshold`` heuristic.)"""
        return self.estimate(route, work, **seed_kw) < self.estimate("serial", work)

    def choose(self, site: str,
               cands: Sequence[Tuple],
               meta: Optional[Dict[str, object]] = None) -> Choice:
        """Pick the cheapest of ``cands`` — each ``(route, work)`` or
        ``(route, work, seed_kwargs)`` — and record a :class:`Decision` when
        a :class:`PlanRecorder` is active on this thread.  The call site
        executes the returned :attr:`Choice.route` (falling down
        :attr:`Choice.ranked` if it proves inviable) and reports the measured
        time via :meth:`Choice.done`."""
        ranked: List[Tuple[float, str, float]] = []
        for c in cands:
            route, work = c[0], float(c[1])
            kw = c[2] if len(c) > 2 else {}
            ranked.append((self.estimate(route, work, **kw), route, work))
        ranked.sort(key=lambda t: t[0])
        est, route, work = ranked[0]
        dec = None
        rec = active_recorder()
        if rec is not None:
            dec = Decision(
                site=site, chosen=route, est_s=est,
                candidates=[{"route": r, "work": w, "est_s": e}
                            for e, r, w in sorted(ranked, key=lambda t: t[1])],
                meta=dict(meta or {}),
            )
            rec.add(dec)
        return Choice(self, route, work, est, ranked, dec)

    def note(self, site: str, route: str, work: float,
             meta: Optional[Dict[str, object]] = None,
             alternatives: Sequence[Tuple] = ()) -> Choice:
        """Record a *structurally determined* decision — a site where the
        route is fixed by program shape (e.g. the batch pivot path), so there
        is no free choice but the estimate/actual pair is still worth
        reporting and learning from."""
        ranked = [(self.estimate(route, work), route, float(work))]
        for c in alternatives:
            r, w = c[0], float(c[1])
            kw = c[2] if len(c) > 2 else {}
            ranked.append((self.estimate(r, w, **kw), r, w))
        dec = None
        rec = active_recorder()
        if rec is not None:
            dec = Decision(
                site=site, chosen=route, est_s=ranked[0][0],
                candidates=[{"route": r, "work": w, "est_s": e}
                            for e, r, w in ranked],
                meta=dict(meta or {}),
            )
            rec.add(dec)
        return Choice(self, route, float(work), ranked[0][0], ranked, dec)

    # -- observation / feedback ---------------------------------------- #
    def observe(self, route: str, work: float, seconds: float,
                est: Optional[float] = None) -> None:
        """Feed one measured (work, seconds) actual back into the route's
        model.  Marginal cost updates by EWMA (only above :data:`WORK_FLOOR`,
        where the timing is not overhead noise); when an estimate was made,
        the est/actual ratio joins the route's error window and a persistent
        >:data:`FLAG_RATIO` disagreement flags the route and invalidates the
        matching dispatch probe (satellite fix: probes taken under load no
        longer poison every later decision — they get re-measured)."""
        ln = self.lin(route)
        with self._lock:
            ln.chosen += 1
            self._n_observed += 1
            if seconds > 0 and work >= WORK_FLOOR:
                inst = max((seconds - ln.a) / work, 1e-13)
                ln.b_obs = inst if ln.n_obs == 0 else (
                    (1.0 - ALPHA) * ln.b_obs + ALPHA * inst
                )
                ln.n_obs += 1
            # overhead-dominated timings (below the work floor) are noise for
            # the flag window too: a microsecond-scale scan whose fixed cost
            # dwarfs its per-row work would otherwise flag the route and
            # churn probe re-measurement without any real estimate error
            if est is not None and seconds > 0 and est > 0 \
                    and work >= WORK_FLOOR:
                ratio = est / seconds
                self._err_recent.append(abs(ratio - 1.0))
                dq = self._errors.get(route)
                if dq is None:
                    dq = self._errors[route] = deque(maxlen=4 * FLAG_WINDOW)
                dq.append(ratio)
                if len(dq) >= FLAG_WINDOW:
                    med = sorted(dq)[len(dq) // 2]
                    if med > FLAG_RATIO or med < 1.0 / FLAG_RATIO:
                        self._flag_locked(route, med, len(dq))
                        dq.clear()

    def _flag_locked(self, route: str, median_ratio: float, window: int) -> None:
        self._flags.append({
            "route": route,
            "median_est_over_actual": float(median_ratio),
            "window": int(window),
            "action": "reprobe",
        })
        # trust observations over the contradicted seed from here on
        ln = self._lins.get(route)
        if ln is not None:
            ln.min_obs = 1
        kind = _DISPATCH_KIND.get(route)
        if kind is not None:
            try:
                from . import dispatch

                dispatch.note_disagreement(kind)
            except Exception:
                pass

    # -- planner hook --------------------------------------------------- #
    def stage_scan_cost(self, nbytes: float, prune_rate: float = 0.0) -> float:
        """Expected bytes effectively touched per lineage-query scan of a
        materialized stage: the surviving fraction after zone-map pruning,
        charged at the pruned route's marginal-cost penalty over a plain
        scan, capped at the full stage (pruning never makes a scan dearer
        than not pruning — the engine falls back to the full scan then).
        ``plan.plan_materialization`` records this per kept stage."""
        kept = min(max(1.0 - float(prune_rate), 0.0), 1.0)
        penalty = (self.lin("pruned", ratio=PRUNED_RATIO).slope()
                   / max(self.lin("serial").slope(), 1e-300))
        return float(min(float(nbytes) * kept * penalty, float(nbytes)))

    # -- introspection --------------------------------------------------- #
    def error_summary(self) -> Dict[str, object]:
        """Distribution of recent absolute estimate errors ``|est/actual-1|``
        across all routes (the BENCH_explain gate input)."""
        with self._lock:
            errs = sorted(self._err_recent)
        if not errs:
            return {"count": 0, "median": None, "p90": None}
        return {
            "count": len(errs),
            "median": float(errs[len(errs) // 2]),
            "p90": float(errs[min(int(len(errs) * 0.9), len(errs) - 1)]),
        }

    def snapshot(self) -> Dict[str, object]:
        """Stable dict of per-route parameters, choice counts, estimate-error
        medians, and feedback flags — merged into ``PlanReport.summary``."""
        with self._lock:
            routes = {r: ln.snapshot() for r, ln in self._lins.items()}
            for r, dq in self._errors.items():
                if r in routes and dq:
                    s = sorted(dq)
                    routes[r]["est_over_actual_median"] = float(s[len(s) // 2])
            flags = [dict(f) for f in self._flags]
            n = self._n_observed
        return {
            "routes": routes,
            "flags": flags,
            "observations": n,
            "error": self.error_summary(),
        }


_DEFAULT: Optional[CostModel] = None
_DEFAULT_LOCK = threading.Lock()


def default_cost_model() -> CostModel:
    """Process-wide fallback model for call sites with no engine in reach
    (the materialization planner).  Engine-owned models are preferred — they
    learn from that engine's actual scans."""
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = CostModel()
    return _DEFAULT


def reset_default_for_tests() -> None:
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = None


# ---------------------------------------------------------------------------
# PlanReport
# ---------------------------------------------------------------------------


@dataclass
class PlanReport:
    """Structured ``explain()`` output: what the engine considered, what it
    chose, what it estimated, and what it measured — for one lineage query.

    ``to_dict()`` is the stable serialized form (``schema_version`` guards
    consumers); ``pretty()`` renders the human view.  ``answer`` carries the live
    :class:`~repro_torch.core.lineage.LineageAnswer` the explained query produced
    (never serialized — ``explain()`` must not change answers, and tests
    differentially verify this field against a plain ``query()``)."""

    pipeline: Dict[str, object]          # budget, partitions, backend, stages
    tables: Dict[str, Dict[str, object]]  # per-table verdict + alternatives
    scans: List[Decision]                # every recorded dispatch decision
    summary: Dict[str, object]           # totals, routes, error stats, flags
    answer: Optional[object] = None      # the LineageAnswer (not serialized)

    def to_dict(self) -> Dict[str, object]:
        return {
            "schema_version": SCHEMA_VERSION,
            "pipeline": dict(self.pipeline),
            "tables": {t: dict(v) for t, v in self.tables.items()},
            "scans": [d.to_dict() for d in self.scans],
            "summary": dict(self.summary),
        }

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True,
                          default=_json_default)

    # -- pretty printer -------------------------------------------------- #
    def pretty(self) -> str:
        out: List[str] = []
        pl = self.pipeline
        out.append("Lineage plan "
                   f"(budget={pl.get('budget_bytes')}, "
                   f"partitions={pl.get('num_partitions')}, "
                   f"backend={pl.get('backend')})")
        for t, info in sorted(self.tables.items()):
            out.append(f"  table {t}: {info.get('verdict')} "
                       f"({info.get('lineage_rows')} rows of {info.get('rows')})")
            for alt in info.get("alternatives", []):
                mark = "*" if alt.get("chosen") else " "
                est = alt.get("est_s")
                est_s = "-" if est is None else f"{est * 1e3:9.3f} ms"
                out.append(f"   {mark} {alt['plan']:<10} est {est_s}"
                           + ("" if alt.get("viable", True) else "  (inviable)"))
        if self.scans:
            out.append("  scans:")
        for d in self.scans:
            actual = "-" if d.actual_s is None else f"{d.actual_s * 1e3:8.3f} ms"
            fb = f" (fell back from {d.fallback_from})" if d.fallback_from else ""
            out.append(f"    {d.site:<24} -> {d.chosen:<13}"
                       f" est {d.est_s * 1e3:8.3f} ms  actual {actual}{fb}")
            alts = ", ".join(
                f"{c['route']}={c['est_s'] * 1e3:.3f}ms"
                for c in d.candidates if c["route"] != d.chosen
            )
            if alts:
                out.append(f"      considered: {alts}")
        sm = self.summary
        out.append(f"  total: est {_ms(sm.get('total_est_s'))}"
                   f"  actual {_ms(sm.get('total_actual_s'))}"
                   f"  query {_ms(sm.get('query_seconds'))}")
        if sm.get("routes"):
            out.append("  routes: " + ", ".join(
                f"{r}x{c}" for r, c in sorted(sm["routes"].items())))
        err = sm.get("estimate_error") or {}
        if err.get("median") is not None:
            out.append(f"  estimate error |est/actual-1|: "
                       f"median {err['median']:.2f}  p90 {err['p90']:.2f}")
        for f in sm.get("flags", []):
            out.append(f"  FLAG: route {f['route']} estimates off "
                       f"{f['median_est_over_actual']:.1f}x over "
                       f"{f['window']} scans -> {f['action']}")
        return "\n".join(out)


def _ms(v) -> str:
    if v is None:
        return "-"
    return f"{float(v) * 1e3:.3f} ms"


def _json_default(o):
    if isinstance(o, (set, frozenset, tuple)):
        return sorted(o) if isinstance(o, (set, frozenset)) else list(o)
    if hasattr(o, "item"):
        return o.item()
    if isinstance(o, float) and math.isnan(o):
        return None
    return str(o)
