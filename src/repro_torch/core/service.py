"""Concurrent lineage query service: coalescing scheduler + answer cache.

PredTrace answers one lineage question per ``query()`` call, and Smoke
(Psallidas & Wu) set the bar the paper's "lineage in seconds" pitch implies:
*interactive* lineage under many concurrent backward/forward queries.  This
module is the serving layer that gets there without touching the query
algorithms themselves:

* :class:`LineageService` admits requests from any number of threads
  (``submit`` returns a future-like :class:`LineageRequest`; ``query`` is the
  blocking convenience).  Every request carries an optional deadline and can
  be cancelled while queued.
* A single dispatcher thread **coalesces** requests that share a pipeline —
  and therefore a materialization budget, which is a property of the
  registered :class:`~repro_torch.core.lineage.PredTrace` — inside a time/size
  window (``window_s`` / ``max_batch``) and answers each group with ONE
  :meth:`PredTrace.query_batch` call, i.e. one scan per table for the whole
  group instead of one scan per table per request.
* A **generation-stamped LRU answer cache** fronts the scans.  Keys are the
  request's *normalized output binding* (the pushed-down parameter values the
  target row concretizes — two different row indexes with equal bindings are
  the same lineage question).  Entries are stamped with
  :meth:`PredTrace.answer_generation`, which changes whenever
  ``Executor.run`` re-executes the pipeline or the
  :class:`~repro_torch.core.store.IntermediateStore` mutates (``put``/``evict`` /
  spill-reload via ``attach_store``), so a re-run can never serve a stale
  answer — it surfaces as a counted ``cache_stale`` miss instead.  An
  *append-only* ``run_delta`` moves only the token's row watermarks: cached
  answers stay warm and are extended in place by
  :meth:`PredTrace.query_delta` (counted ``delta_hits``), rescanning only
  the appended partitions — zero rescans when the answer's pruned partition
  set is untouched.  Tokens are re-checked at cache-insert time; a
  run racing a scan drops the insert (``cache_race_drops``) instead of
  caching a possibly inconsistent answer under a live token.

Correctness contract: every answer is produced by the registered PredTrace's
own ``query``/``query_batch`` (bit-identical by the engine's batching
invariant) or is a cached copy of such an answer under an unchanged
generation token.  Concurrency in the engine layers below (ScanEngine and
TorchBackend caches) is lock-protected, so a service can also share an
engine with out-of-band callers.

Device scans run on the dispatcher thread only: ``query_batch`` for a
group's misses and ``query_delta`` for a cached answer it extends across
an append (the submit fast path serves exact-token hits alone).  Each
kernel launch goes to the current stream of the scan's device and ends in
its mask readback, so an answer is complete when the call returns.  A
launch error raises there and fails the requests that scan was for; the
dispatcher never answers from the host in its place.

Observability follows the ``stats()`` pattern of :class:`ScanStats`: counters
(submitted/answered/expired/cancelled, coalesced batches and widths, cache
hit/stale rates) plus a latency reservoir with p50/p99 — see
:meth:`LineageService.stats`.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .lineage import LineageAnswer, PredTrace, delta_compatible
from .scan import LRUCache

RowSpec = Union[int, Dict[str, object]]


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before an answer was produced."""


class RequestCancelled(RuntimeError):
    """The request was cancelled (or the service closed) before an answer
    was produced."""


# request states
_PENDING, _DONE, _CANCELLED, _EXPIRED, _FAILED = (
    "pending", "done", "cancelled", "expired", "failed")


class LineageRequest:
    """Future-like handle for one submitted lineage question.

    State transitions are one-way (pending -> done/cancelled/expired/failed)
    and guarded by a per-request lock, so a racing ``cancel()`` and
    dispatcher fulfilment agree on a single outcome."""

    __slots__ = ("pipeline", "row", "deadline", "submitted_at", "cache_key",
                 "_event", "_lock", "_state", "_answer", "_error")

    def __init__(self, pipeline: str, row: RowSpec,
                 deadline: Optional[float]):
        self.pipeline = pipeline
        self.row = row
        self.deadline = deadline  # absolute time.monotonic() stamp, or None
        self.submitted_at = time.monotonic()
        # normalized-binding cache key, computed once at submit and reused by
        # the dispatcher; None when submit-time normalization failed (the
        # dispatcher then fails the request uniformly)
        self.cache_key: Optional[Tuple] = None
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._state = _PENDING
        self._answer: Optional[LineageAnswer] = None
        self._error: Optional[BaseException] = None

    # -- inspection ---------------------------------------------------- #
    def done(self) -> bool:
        return self._state != _PENDING

    def cancelled(self) -> bool:
        return self._state == _CANCELLED

    def expired(self) -> bool:
        return self._state == _EXPIRED

    def remaining(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds until the deadline (None = no deadline)."""
        if self.deadline is None:
            return None
        return self.deadline - (time.monotonic() if now is None else now)

    # -- transitions --------------------------------------------------- #
    def cancel(self) -> bool:
        """Cancel a queued request.  Returns True when this call (or an
        earlier one) won the race; a request already answered or expired
        stays answered/expired."""
        with self._lock:
            if self._state == _PENDING:
                self._state = _CANCELLED
            ok = self._state == _CANCELLED
        self._event.set()
        return ok

    def _fulfill(self, answer: LineageAnswer) -> bool:
        with self._lock:
            if self._state != _PENDING:
                return False
            self._state = _DONE
            self._answer = answer
        self._event.set()
        return True

    def _fail(self, err: BaseException, state: str = _FAILED) -> bool:
        with self._lock:
            if self._state != _PENDING:
                return False
            self._state = state
            self._error = err
        self._event.set()
        return True

    # -- await --------------------------------------------------------- #
    def result(self, timeout: Optional[float] = None) -> LineageAnswer:
        """Block for the answer.  Raises :class:`DeadlineExceeded` when the
        request's deadline passes first (expiring the request, so the
        dispatcher will skip it), :class:`RequestCancelled` after
        ``cancel()``/service shutdown, ``TimeoutError`` when only the local
        ``timeout`` ran out, or the original error when the query failed."""
        wait: Optional[float] = timeout
        rem = self.remaining()
        if rem is not None:
            wait = rem if wait is None else min(wait, rem)
        self._event.wait(wait)
        if not self.done():
            rem = self.remaining()
            if rem is not None and rem <= 0:
                self._fail(DeadlineExceeded("deadline passed while queued"),
                           _EXPIRED)
            else:
                raise TimeoutError("result(timeout=...) elapsed before the "
                                   "request was answered")
        if self._state == _DONE:
            return self._answer
        if self._state == _CANCELLED:
            raise RequestCancelled("lineage request was cancelled")
        if self._state == _EXPIRED:
            raise DeadlineExceeded("lineage request deadline exceeded")
        raise self._error


class ServiceStats:
    """Thread-safe service counters + latency reservoir.

    Mirrors the :class:`~repro_torch.core.scan.ScanStats` pattern: plain integer
    attributes guarded by a lock for increments, and a callable snapshot
    (``service.stats()``) that adds the derived numbers — coalesce width,
    cache hit rate, p50/p99 latency."""

    RESERVOIR = 4096

    def __init__(self):
        self._lock = threading.Lock()
        self.submitted = 0
        self.answered = 0
        self.failed = 0
        self.expired = 0
        self.cancelled = 0
        # one "batch" = one dispatcher pass over one pipeline's group
        self.batches = 0
        self.coalesced_requests = 0   # requests folded into those batches
        self.batch_queries = 0        # distinct rows actually queried
        self.max_coalesce = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.cache_stale = 0          # generation-mismatch invalidations
        # entries extended in place across an append-only delta run
        # (PredTrace.query_delta): served warm, restamped under the new token
        self.delta_hits = 0
        # answers NOT cached because the generation token changed between
        # the pre-query read and insert time (a run()/run_delta() raced the
        # scan) — the insert-time re-check drops them instead of caching a
        # potentially inconsistent answer under a live token
        self.cache_race_drops = 0
        # answers whose per-table precise flags were not all True: budget
        # degradation or an unmaterialized opaque-UDF stage produced a
        # (well-defined) superset instead of exact lineage
        self.superset_answers = 0
        # answers served while at least one queried stage lived on the
        # out-of-core (memmap) tier — still precise, paid at disk bandwidth
        self.disk_tier_answers = 0
        self._latencies = deque(maxlen=self.RESERVOIR)

    def bump(self, **deltas: int) -> None:
        with self._lock:
            for k, v in deltas.items():
                setattr(self, k, getattr(self, k) + v)

    def record_batch(self, requests: int, queries: int) -> None:
        with self._lock:
            self.batches += 1
            self.coalesced_requests += requests
            self.batch_queries += queries
            self.max_coalesce = max(self.max_coalesce, requests)

    def record_latency(self, seconds: float) -> None:
        with self._lock:
            self._latencies.append(seconds)

    # optional zero-arg callable merged into the snapshot under "cost_model"
    # (the LineageService wires this to its pipelines' cost-model snapshots)
    extra_provider = None
    # optional zero-arg callable merged under "store_tiers": per-pipeline
    # RAM/disk residency summaries from the out-of-core store tier
    tier_provider = None

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            out: Dict[str, object] = {
                k: v for k, v in self.__dict__.items() if isinstance(v, int)
            }
            lat = np.asarray(self._latencies, dtype=np.float64)
        out["coalesce_width_avg"] = (
            out["coalesced_requests"] / out["batches"] if out["batches"] else 0.0
        )
        out["coalesce_width_max"] = out.pop("max_coalesce")
        looked = out["cache_hits"] + out["cache_misses"]
        out["cache_hit_rate"] = out["cache_hits"] / looked if looked else 0.0
        out["superset_rate"] = (
            out["superset_answers"] / out["answered"] if out["answered"] else 0.0
        )
        if len(lat):
            out["latency_ms_p50"] = float(np.percentile(lat, 50) * 1e3)
            out["latency_ms_p99"] = float(np.percentile(lat, 99) * 1e3)
        else:
            out["latency_ms_p50"] = out["latency_ms_p99"] = 0.0
        if self.extra_provider is not None:
            out["cost_model"] = self.extra_provider()
        if self.tier_provider is not None:
            tiers = self.tier_provider()
            if tiers:
                out["store_tiers"] = tiers
        return out

    __call__ = snapshot


def _binding_cache_key(pt: PredTrace, row: RowSpec) -> Tuple:
    """Normalized output binding of ``row`` — the cache identity of a lineage
    question.  Array values hash by dtype/shape/bytes; scalars by type and
    value (NaN keys simply never hit, which is safe)."""
    binding = pt._output_binding(row)
    parts: List[Tuple] = []
    for p in sorted(binding):
        v = binding[p]
        if isinstance(v, np.ndarray):
            parts.append((p, "a", v.dtype.str, v.shape, v.tobytes()))
        else:
            parts.append((p, type(v).__name__, v))
    return tuple(parts)


def _cache_key(pipeline: str, pt: PredTrace, row: RowSpec) -> Tuple:
    """Full answer-cache key: pipeline name, the pipeline's *precision mode*
    (budget + dropped stages), and the normalized binding.  The precision
    token keeps a superset answer produced under a tight budget from ever
    being served after the caller restored precision (e.g. by attaching a
    fully-populated store) — generation stamps alone cannot distinguish the
    two when the data they derive from coincides."""
    return (pipeline, pt.precision_token(), _binding_cache_key(pt, row))


class LineageService:
    """Thread-safe lineage serving over registered PredTrace pipelines.

    ``pipelines`` maps name -> PredTrace (each already ``infer()``-ed and
    ``run()``); a bare PredTrace registers as ``"default"``.  ``submit``
    enqueues from any thread; one dispatcher thread windows the queue
    (``window_s`` seconds or ``max_batch`` requests, whichever first),
    groups by pipeline, serves what it can from the answer cache, and
    coalesces the rest into one ``query_batch`` per pipeline."""

    # quiescence quantum: the window is a MAX bound; once no new request
    # arrives for this long the batch is considered complete and dispatches
    # early, so a lone request never stalls for the whole window
    IDLE_QUANTUM_S = 0.0002

    def __init__(
        self,
        pipelines: Union[PredTrace, Dict[str, PredTrace], None] = None,
        *,
        max_batch: int = 64,
        window_s: float = 0.002,
        idle_quantum_s: float = IDLE_QUANTUM_S,
        cache_entries: int = 1024,
        name: str = "lineage-service",
    ):
        self.max_batch = max(int(max_batch), 1)
        self.window_s = float(window_s)
        self.idle_quantum_s = float(idle_quantum_s)
        self._pipelines: Dict[str, PredTrace] = {}
        # answer cache: (pipeline, normalized binding) -> (generation, answer)
        self._cache = LRUCache(cache_entries)
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._closed = False
        self.stats = ServiceStats()
        self.stats.extra_provider = self._cost_stats
        self.stats.tier_provider = self._tier_stats
        # test seam: called (with the pipeline key) on the dispatcher thread
        # after the generation token is read and before the query dispatches —
        # lets a race test hold the window open while another thread re-runs
        # the pipeline, exercising the insert-time token re-check
        self._pre_query_hook = None
        if isinstance(pipelines, PredTrace):
            self.register("default", pipelines)
        elif pipelines:
            for k, pt in pipelines.items():
                self.register(k, pt)
        self._thread = threading.Thread(
            target=self._dispatch_loop, name=name, daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------------ #
    def register(self, key: str, pt: PredTrace) -> None:
        """Register a pipeline for serving.  The PredTrace must have
        completed inference and the pipeline-execution phase."""
        assert pt.lineage_plan is not None and pt.exec_result is not None, (
            "infer() and run() the PredTrace before registering it"
        )
        self._pipelines[key] = pt

    def pipelines(self) -> List[str]:
        """Registered pipeline keys, sorted."""
        return sorted(self._pipelines)

    def _cost_stats(self) -> Dict[str, object]:
        """Per-pipeline scan cost-model snapshot (routes, estimate-error
        stats, feedback flags) — merged into ``stats()`` as ``cost_model``."""
        return {
            key: pt.scan_engine.cost_model.snapshot()
            for key, pt in sorted(self._pipelines.items())
        }

    def _tier_stats(self) -> Dict[str, object]:
        """Per-pipeline store-tier residency (stage counts and bytes on the
        RAM vs out-of-core tiers, plus demotion/promotion counters) — merged
        into ``stats()`` as ``store_tiers``.  Pipelines without an attached
        store are omitted."""
        return {
            key: pt.store.tier_summary()
            for key, pt in sorted(self._pipelines.items())
            if pt.store is not None
        }

    def explain(self, row: RowSpec, pipeline: str = "default"):
        """Synchronous plan explanation: run ``row``'s lineage query on the
        named pipeline with plan recording on and return the
        :class:`~repro_torch.core.cost.PlanReport` (see ``PredTrace.explain``).

        Runs on the caller's thread, bypassing the coalescing scheduler and
        the answer cache — an explained query is a diagnostic probe, not a
        served answer (the answer is still exact and carried on
        ``report.answer``).

        Args:
            row: output row selector — row index (``int``) or column-value
                dict.
            pipeline: registered pipeline key (default ``"default"``).

        Returns:
            PlanReport: structured plan/cost breakdown for the query.
        """
        if pipeline not in self._pipelines:
            raise KeyError(f"unknown pipeline {pipeline!r}")
        return self._pipelines[pipeline].explain(row)

    # ------------------------------------------------------------------ #
    def _lookup(self, pt: PredTrace, ck: Tuple, gen,
                extend: bool = True) -> Optional[LineageAnswer]:
        """Answer-cache lookup with delta extension.  An exact token match
        serves the entry as-is.  A :func:`delta_compatible` mismatch — the
        same generation base, row watermarks only moved forward by an
        append-only ``run_delta`` — is *extended* via
        :meth:`PredTrace.query_delta` (rescanning only the delta
        partitions), restamped under the current token, and served warm;
        answers whose pruned partition set the append did not touch pay
        zero rescans.  Anything else is popped as stale.  Returns the
        served answer or None (caller counts the miss and re-queries).

        ``query_delta`` scans the appended partitions through the engine,
        so an extension launches kernels: only the dispatcher extends
        (``extend=True``), and an error there propagates to the request.
        With ``extend=False`` (the submit fast path) a delta-compatible
        entry is left in place and None returned uncounted, so the
        dispatcher extends it."""
        entry = self._cache.get(ck)
        if entry is None:
            return None
        if entry[0] == gen:
            self.stats.bump(cache_hits=1)
            return entry[1]
        if delta_compatible(entry[0], gen):
            if not extend:
                return None
            ext = pt.query_delta(entry[1], entry[0])
            if ext is not None:
                # restamp only while the token still holds (a run racing
                # the extension must not publish under a live token)
                if pt.answer_generation() == gen:
                    self._cache[ck] = (gen, ext)
                self.stats.bump(cache_hits=1, delta_hits=1)
                return ext
        self.stats.bump(cache_stale=1)
        self._cache.pop(ck)
        return None

    # ------------------------------------------------------------------ #
    def submit(self, row: RowSpec, pipeline: str = "default",
               timeout: Optional[float] = None) -> LineageRequest:
        """Enqueue a lineage question; returns a :class:`LineageRequest`.
        ``timeout`` sets the request deadline (seconds from now)."""
        if self._closed:
            raise RequestCancelled("service is closed")
        if pipeline not in self._pipelines:
            raise KeyError(f"unknown pipeline {pipeline!r}; "
                           f"registered: {self.pipelines()}")
        deadline = None if timeout is None else time.monotonic() + timeout
        req = LineageRequest(pipeline, row, deadline)
        self.stats.bump(submitted=1)
        # fast path: a warm exact-token hit is served synchronously on the
        # caller's thread — no scheduler round-trip, no coalescing-window
        # latency.  Entries that need a delta extension, and missing ones,
        # go to the dispatcher, which owns every scan and recompute.
        pt = self._pipelines[pipeline]
        ans = self._fast_lookup(pt, req, pt.answer_generation())
        if ans is not None:
            self._finish(req, ans, cached=True)
            return req
        self._enqueue([req])
        return req

    def _fast_lookup(self, pt: PredTrace, req: LineageRequest,
                     gen) -> Optional[LineageAnswer]:
        """Submit-time cache key and exact-token lookup; scans nothing.  A
        row that fails to normalize is left to the dispatcher, which fails
        it uniformly."""
        try:
            req.cache_key = _cache_key(req.pipeline, pt, req.row)
        except Exception:
            return None
        return self._lookup(pt, req.cache_key, gen, extend=False)

    def submit_many(self, rows: List[RowSpec], pipeline: str = "default",
                    timeout: Optional[float] = None) -> List[LineageRequest]:
        """Page submission: enqueue a batch of rows with ONE queue lock and
        ONE dispatcher wake-up.  Warm exact-token hits are still served
        synchronously per row; the misses arrive at the scheduler already
        coalesced, so a dashboard page costs one scan per table."""
        if self._closed:
            raise RequestCancelled("service is closed")
        if pipeline not in self._pipelines:
            raise KeyError(f"unknown pipeline {pipeline!r}; "
                           f"registered: {self.pipelines()}")
        deadline = None if timeout is None else time.monotonic() + timeout
        pt = self._pipelines[pipeline]
        gen = pt.answer_generation()
        out: List[LineageRequest] = []
        queued: List[LineageRequest] = []
        self.stats.bump(submitted=len(rows))
        for row in rows:
            req = LineageRequest(pipeline, row, deadline)
            out.append(req)
            ans = self._fast_lookup(pt, req, gen)
            if ans is not None:
                self._finish(req, ans, cached=True)
                continue
            queued.append(req)
        if queued:
            self._enqueue(queued)
        return out

    def _enqueue(self, reqs: List[LineageRequest]) -> None:
        """Append under the queue lock, re-checking closed-ness: a close()
        racing past the submit-time check must not strand requests in a
        queue nobody drains."""
        with self._cond:
            if not self._closed:
                self._queue.extend(reqs)
                self._cond.notify_all()
                return
        for r in reqs:
            if r._fail(RequestCancelled("service closed"), _CANCELLED):
                self.stats.bump(cancelled=1)

    def query(self, row: RowSpec, pipeline: str = "default",
              timeout: Optional[float] = None) -> LineageAnswer:
        """Blocking convenience: ``submit(...).result()``."""
        return self.submit(row, pipeline, timeout).result()

    # ------------------------------------------------------------------ #
    def close(self, wait: bool = True) -> None:
        """Stop the dispatcher.  Queued-but-unanswered requests fail with
        :class:`RequestCancelled`."""
        with self._cond:
            if self._closed:
                leftovers = []
            else:
                self._closed = True
                leftovers = list(self._queue)
                self._queue.clear()
            self._cond.notify_all()
        for r in leftovers:
            if r._fail(RequestCancelled("service closed"), _CANCELLED):
                self.stats.bump(cancelled=1)
        if wait and self._thread.is_alive():
            self._thread.join(timeout=30.0)

    def __enter__(self) -> "LineageService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ #
    def _dispatch_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue and self._closed:
                    return
                # coalescing window: hold the batch open while it is still
                # growing, up to window_s; a full batch dispatches
                # immediately, and a quiescent queue (no arrival within one
                # idle quantum) dispatches early so a lone request never
                # pays the whole window as latency
                t0 = time.monotonic()
                seen = len(self._queue)
                while (len(self._queue) < self.max_batch
                       and not self._closed):
                    remaining = self.window_s - (time.monotonic() - t0)
                    if remaining <= 0:
                        break
                    self._cond.wait(min(self.idle_quantum_s, remaining))
                    if len(self._queue) == seen:
                        break  # quiescent: nobody is about to join this batch
                    seen = len(self._queue)
                batch = list(self._queue)
                self._queue.clear()
            try:
                self._run_batch(batch)
            except Exception as e:  # pragma: no cover - defensive backstop
                for r in batch:
                    if r._fail(e):
                        self.stats.bump(failed=1)

    # ------------------------------------------------------------------ #
    def _run_batch(self, batch: List[LineageRequest]) -> None:
        now = time.monotonic()
        by_pipe: Dict[str, List[LineageRequest]] = {}
        for r in batch:
            # the dispatcher dequeues each request exactly once, so it is the
            # single accounting point for expiry/cancellation — even when
            # result()/cancel() already flipped the state
            if r.cancelled():
                self.stats.bump(cancelled=1)
                continue
            rem = r.remaining(now)
            if r.expired() or (rem is not None and rem <= 0):
                r._fail(DeadlineExceeded("deadline passed while queued"),
                        _EXPIRED)
                self.stats.bump(expired=1)
                continue
            by_pipe.setdefault(r.pipeline, []).append(r)
        for key, reqs in by_pipe.items():
            self._serve_pipeline(key, reqs)

    def _serve_pipeline(self, key: str, reqs: List[LineageRequest]) -> None:
        pt = self._pipelines[key]
        gen = pt.answer_generation()
        # cache pass: serve hits, dedupe the misses by binding so N requests
        # for one lineage question cost one query row
        misses: Dict[Tuple, List[LineageRequest]] = {}
        for r in reqs:
            ck = r.cache_key  # computed once at submit time
            if ck is None:
                try:
                    ck = _cache_key(key, pt, r.row)
                except Exception as e:
                    if r._fail(e):
                        self.stats.bump(failed=1)
                    continue
            try:
                ans = self._lookup(pt, ck, gen)
            except Exception as e:
                # a delta extension's scan failed: the request fails with it
                if r._fail(e):
                    self.stats.bump(failed=1)
                continue
            if ans is not None:
                self._finish(r, ans, cached=True)
                continue
            self.stats.bump(cache_misses=1)
            misses.setdefault(ck, []).append(r)
        if not misses:
            return
        hook = self._pre_query_hook
        if hook is not None:
            hook(key)
        groups = list(misses.items())
        rows = [grp[0].row for _, grp in groups]
        served = sum(len(grp) for _, grp in groups)
        try:
            answers = (pt.query_batch(rows) if len(rows) > 1
                       else [pt.query(rows[0])])
        except Exception as e:
            for _, grp in groups:
                for r in grp:
                    if r._fail(e):
                        self.stats.bump(failed=1)
            return
        self.stats.record_batch(requests=served, queries=len(rows))
        if pt.store is not None and pt.store.disk_stages():
            # answered while stages sat on the out-of-core tier: precise,
            # but paid at memmap (page-fault) bandwidth — tracked so tier
            # pressure is visible in stats() alongside superset_rate
            self.stats.bump(disk_tier_answers=len(rows))
        # insert-time token re-check: a run()/run_delta() that raced the scan
        # means these answers may mix pre- and post-run state — caching them
        # under either token could serve a stale answer as current.  Fulfil
        # the waiting requests (best effort, flagged) but drop the cache
        # inserts; the next query recomputes under a settled token.
        cacheable = pt.answer_generation() == gen
        if not cacheable:
            self.stats.bump(cache_race_drops=len(groups))
        for (ck, grp), ans in zip(groups, answers):
            if cacheable:
                self._cache[ck] = (gen, ans)
            for r in grp:
                self._finish(r, ans)

    def _finish(self, r: LineageRequest, ans: LineageAnswer,
                cached: bool = False) -> None:
        # per-request copy: answers are shared via the cache, so detail
        # must not be mutated on a shared object
        out = LineageAnswer(ans.lineage, ans.seconds, dict(ans.detail),
                            dict(ans.precise))
        if cached:
            out.detail["cache"] = "hit"
        if r._fulfill(out):
            self.stats.bump(answered=1,
                            superset_answers=0 if out.all_precise() else 1)
            self.stats.record_latency(time.monotonic() - r.submitted_at)
        else:
            # lost to a concurrent cancel()/expiry between dequeue and now
            self.stats.bump(cancelled=1 if r.cancelled() else 0,
                            expired=1 if r.expired() else 0)
