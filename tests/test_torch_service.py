"""The port's ``LineageService`` against the JAX package's.

The cases of ``tests/test_service.py``: the same request sequences go to a
service over the port's pipelines (``device="cpu"``, device cutovers at 0,
so every in-fragment scan runs the kernels' plain versions on the
dispatcher thread) and to one over the reference's.  Answers must be
identical, and so must the coalescing, cache, stale and ``delta_hits``
counters wherever the sequence fixes them; a 32-thread stress run checks
answers only, since its coalescing depends on thread timing.  Deadlines,
cancellation and closing behave as in the reference, and a launch error
raised on the dispatcher thread reaches the request.

Every blocking wait carries a timeout, so a scheduler deadlock fails fast.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from test_torch_incremental import (BOTH, PORT, REF, forced_device,  # noqa: F401
                                    monotone_pt)
from test_torch_lineage_tpch import _as_numpy, _same_answer

JOIN_TIMEOUT = 120.0
COUNTERS = ("submitted", "answered", "batches", "coalesced_requests",
            "batch_queries", "coalesce_width_max", "cache_hits",
            "cache_misses", "cache_stale", "delta_hits", "superset_answers",
            "expired", "cancelled", "failed")


@pytest.fixture(scope="module")
def dbs():
    from repro.tpch import generate

    ref = generate(sf=0.002, seed=1)
    return {REF: ref,
            PORT: PORT.table.catalog_from_numpy(_as_numpy(ref), device="cpu")}


def prep(pkg, db, qname, **kw):
    plan = pkg.queries[qname](db)
    res = pkg.Executor(db).run(plan)
    pt = pkg.PredTrace(db, plan, **kw)
    pt.infer(stats=res.stats)
    pt.run()
    return pt


def _pipelines(pkg, db):
    pts = {
        "q3": prep(pkg, db, "q3"),
        "q3.part": prep(pkg, db, "q3", num_partitions=8),
        "q10.store": prep(pkg, db, "q10", store=True, num_partitions=8),
        "q10.b0": prep(pkg, db, "q10", budget_bytes=0),
        "q1": prep(pkg, db, "q1"),
    }
    full = prep(pkg, db, "q3", store=True)
    half = max(full.store.nbytes() // 2, 1)
    full.close()
    pts["q3.partial"] = prep(pkg, db, "q3", budget_bytes=half,
                             num_partitions=8)
    return pts


@pytest.fixture(scope="module")
def pipelines(dbs):
    mp = pytest.MonkeyPatch()
    mp.setenv("PREDTRACE_DEVICE_CUTOVER", "0")
    mp.setenv("PREDTRACE_MEMBER_CUTOVER", "0")
    mp.setenv("PREDTRACE_RLE_CUTOVER", "0")
    pts = {pkg: _pipelines(pkg, dbs[pkg]) for pkg in BOTH}
    yield pts
    mp.undo()
    for by_key in pts.values():
        for pt in by_key.values():
            pt.close()


@pytest.fixture(scope="module")
def expected(pipelines):
    """Serial query() of the reference per (pipeline, row)."""
    out = {}
    for key, pt in pipelines[REF].items():
        for row in range(min(pt.exec_result.output.nrows, 12)):
            out[(key, row)] = pt.query(row)
    return out


def counters(st):
    return {k: st[k] for k in COUNTERS}


def assert_answers(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _same_answer(a, b)
        assert a.detail.get("cache") == b.detail.get("cache")


# --------------------------------------------------------------------------- #
# deterministic request sequences: answers and counters equal the reference
# --------------------------------------------------------------------------- #

def _zipf_requests(pts, n, seed):
    """``launch/lineage_serve.py``'s workload: pipelines round-robin, rows
    Zipf(1.5)."""
    rng = np.random.default_rng(seed)
    names = sorted(pts)
    reqs = []
    for i in range(n):
        q = names[i % len(names)]
        nr = min(pts[q].exec_result.output.nrows, 12)
        ranks = np.arange(1, nr + 1, dtype=np.float64) ** -1.5
        reqs.append((q, int(rng.choice(nr, p=ranks / ranks.sum()))))
    return reqs


def _serve_pages(pkg, pts, reqs, page):
    """One client, pages of ``page`` requests through submit_many, each page
    awaited before the next: every page is one dispatcher batch."""
    svc = pkg.service.LineageService(pts, max_batch=32, window_s=0.003)
    out = []
    try:
        for j in range(0, len(reqs), page):
            chunk = reqs[j:j + page]
            handles = []
            for q in sorted({q for q, _ in chunk}):
                idx = [i for i, (qq, _) in enumerate(chunk) if qq == q]
                hs = svc.submit_many([chunk[i][1] for i in idx], q,
                                     timeout=JOIN_TIMEOUT)
                handles += list(zip(idx, hs))
            got = [None] * len(chunk)
            for i, h in handles:
                got[i] = h.result(JOIN_TIMEOUT)
            out += got
        return out, counters(svc.stats())
    finally:
        svc.close()


@pytest.mark.parametrize("page", [1, 16])
def test_zipf_pages_match_reference(pipelines, page):
    reqs = _zipf_requests(pipelines[REF], 64, seed=1)
    got = {pkg: _serve_pages(pkg, pipelines[pkg], reqs, page) for pkg in BOTH}
    assert_answers(got[PORT][0], got[REF][0])
    assert got[PORT][1] == got[REF][1]
    st = got[PORT][1]
    assert st["answered"] == 64 and st["failed"] == 0 and st["cache_hits"] > 0
    if page > 1:
        assert st["coalesce_width_max"] >= 2


def test_coalesced_batch_matches_reference(pipelines, expected):
    rows = [0, 1, 2, 3, 0, 1, 2, 3]
    got = {}
    for pkg in BOTH:
        svc = pkg.service.LineageService(pipelines[pkg], max_batch=8,
                                         window_s=0.05)
        reqs = svc.submit_many(rows, "q3.part", timeout=JOIN_TIMEOUT)
        got[pkg] = [r.result(JOIN_TIMEOUT) for r in reqs], counters(svc.stats())
        svc.close()
    assert_answers(got[PORT][0], got[REF][0])
    for row, ans in zip(rows, got[PORT][0]):
        _same_answer(ans, expected[("q3.part", row)])
    assert got[PORT][1] == got[REF][1]
    assert got[PORT][1]["batches"] == 1
    assert got[PORT][1]["coalesce_width_max"] == 8
    assert got[PORT][1]["batch_queries"] == 4


def _invalidation(pkg, db):
    pt = prep(pkg, db, "q10", store=True)
    svc = pkg.service.LineageService(pt, window_s=0.001)
    answers = [svc.query(0, timeout=JOIN_TIMEOUT),
               svc.query(0, timeout=JOIN_TIMEOUT)]
    gen = pt.answer_generation()
    pt.run()
    assert pt.answer_generation() != gen
    answers.append(svc.query(0, timeout=JOIN_TIMEOUT))
    gen = pt.answer_generation()
    pt.store.evict(list(pt.store.stages)[:1])
    assert pt.answer_generation() != gen
    st = counters(svc.stats())
    svc.close()
    pt.close()
    return answers, st


def test_cache_hits_and_generation_invalidation(dbs):
    got = {pkg: _invalidation(pkg, dbs[pkg]) for pkg in BOTH}
    assert_answers(got[PORT][0], got[REF][0])
    assert got[PORT][1] == got[REF][1]
    a = got[PORT][0]
    assert a[1].detail.get("cache") == "hit" and a[2].detail.get("cache") != "hit"
    assert got[PORT][1]["cache_stale"] >= 1


class _PinnedGeneration:
    """A PredTrace with a frozen answer-generation token: only the cache key
    can keep precise and superset answers apart."""

    def __init__(self, pt):
        self._pt = pt
        self._gen = pt.answer_generation()

    def __getattr__(self, name):
        return getattr(self._pt, name)

    def answer_generation(self):
        return self._gen


def _precision_flip(pkg, db):
    inner = prep(pkg, db, "q3", store=True)
    svc = pkg.service.LineageService({"q3": _PinnedGeneration(inner)},
                                     window_s=0.001)
    answers = [svc.query(0, "q3", timeout=JOIN_TIMEOUT)]
    inner.budget_bytes = 0
    inner.attach_store(inner.store)
    answers.append(svc.query(0, "q3", timeout=JOIN_TIMEOUT))
    answers.append(svc.query(0, "q3", timeout=JOIN_TIMEOUT))
    st = svc.stats()
    svc.close()
    inner.close()
    return answers, counters(st), st["superset_rate"]


def test_cache_key_includes_precision_mode(dbs):
    got = {pkg: _precision_flip(pkg, dbs[pkg]) for pkg in BOTH}
    assert_answers(got[PORT][0], got[REF][0])
    assert got[PORT][1:] == got[REF][1:]
    precise, degraded, again = got[PORT][0]
    assert precise.all_precise() and not degraded.all_precise()
    assert degraded.detail.get("cache") != "hit"
    assert again.detail.get("cache") == "hit"
    for tab, rids in precise.lineage.items():
        assert set(rids.tolist()) <= set(
            degraded.lineage.get(tab, rids[:0]).tolist())


def test_equal_bindings_share_one_cache_entry(pipelines):
    pt = pipelines[PORT]["q3"]
    svc = PORT.service.LineageService(pt, window_s=0.001)
    out = pt.exec_result.output
    a = svc.query(0, timeout=JOIN_TIMEOUT)
    b = svc.query({c: out.cols[c][0] for c in out.columns},
                  timeout=JOIN_TIMEOUT)
    assert b.detail.get("cache") == "hit"
    _same_answer(a, b)
    svc.close()


def test_stats_keys_match_reference(pipelines):
    keys = {}
    for pkg in BOTH:
        svc = pkg.service.LineageService(pipelines[pkg], window_s=0.001)
        svc.query(0, "q10.store", timeout=JOIN_TIMEOUT)
        keys[pkg] = set(svc.stats())
        svc.close()
    assert keys[PORT] == keys[REF]


# --------------------------------------------------------------------------- #
# concurrency, deadlines, cancellation, failures
# --------------------------------------------------------------------------- #

def test_stress_32_threads_identical_answers(pipelines, expected):
    svc = PORT.service.LineageService(pipelines[PORT], max_batch=16,
                                      window_s=0.005)
    keys = sorted({k for k, _ in expected})
    results, errors = {}, []

    def client(tid):
        rng = np.random.default_rng(tid)
        try:
            for j in range(8):
                key = keys[rng.integers(len(keys))]
                n_rows = len([1 for (k, _) in expected if k == key])
                row = int(rng.integers(n_rows))
                ans = svc.submit(row, key, timeout=JOIN_TIMEOUT).result()
                results[(tid, j)] = (key, row, ans)
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append((tid, e))

    threads = [threading.Thread(target=client, args=(t,), daemon=True)
               for t in range(32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_TIMEOUT)
    hung = [t for t in threads if t.is_alive()]
    svc.close()
    assert not hung and not errors, (len(hung), errors[:3])
    assert len(results) == 32 * 8
    for key, row, ans in results.values():
        _same_answer(ans, expected[(key, row)])
    st = svc.stats()
    assert st["answered"] == st["submitted"] == 32 * 8
    assert st["failed"] == st["expired"] == 0
    assert st["coalesced_requests"] + st["cache_hits"] == 32 * 8
    assert st["cache_hits"] > 0
    assert st["latency_ms_p99"] >= st["latency_ms_p50"] > 0.0


class _SlowPipeline:
    """Stalls every query, pinning the dispatcher so later requests expire
    or are cancelled in the queue."""

    def __init__(self, pt, delay_s):
        self._pt = pt
        self._delay = delay_s

    def __getattr__(self, name):
        return getattr(self._pt, name)

    def query(self, row):
        time.sleep(self._delay)
        return self._pt.query(row)

    def query_batch(self, rows):
        time.sleep(self._delay)
        return self._pt.query_batch(rows)


def test_deadline_expired_raises_cleanly(pipelines):
    D = PORT.service
    svc = D.LineageService({"q3": _SlowPipeline(pipelines[PORT]["q3"], 0.15)},
                           max_batch=1, window_s=0.001)
    stall = svc.submit(0, "q3", timeout=JOIN_TIMEOUT)
    req = svc.submit(1, "q3", timeout=0.01)
    with pytest.raises(D.DeadlineExceeded):
        req.result()
    assert req.expired() and req.done()
    assert stall.result(JOIN_TIMEOUT).lineage
    assert svc.submit(0, "q3", timeout=JOIN_TIMEOUT).result(JOIN_TIMEOUT).lineage
    deadline = time.monotonic() + 30
    while svc.stats()["expired"] < 1:
        assert time.monotonic() < deadline, svc.stats()
    svc.close()
    zero = D.LineageService(pipelines[PORT], window_s=0.001)
    req = zero.submit(0, "q3", timeout=0.0)
    with pytest.raises(D.DeadlineExceeded):
        req.result()
    assert req.expired()
    zero.close()


def test_cancel_and_close_semantics(pipelines):
    D = PORT.service
    svc = D.LineageService({"q3": _SlowPipeline(pipelines[PORT]["q3"], 0.15)},
                           max_batch=1, window_s=0.001)
    svc.submit(0, "q3", timeout=JOIN_TIMEOUT)
    req = svc.submit(1, "q3", timeout=30)
    assert req.cancel() and req.cancel()
    with pytest.raises(D.RequestCancelled):
        req.result(JOIN_TIMEOUT)
    with pytest.raises(KeyError):
        svc.submit(0, "no-such-pipeline")
    pending = svc.submit(2, "q3", timeout=30)
    svc.close()
    with pytest.raises(D.RequestCancelled):
        pending.result(JOIN_TIMEOUT)
    with pytest.raises(D.RequestCancelled):
        svc.submit(0, "q3")
    late = D.LineageRequest("q3", 0, None)
    svc._enqueue([late])
    with pytest.raises(D.RequestCancelled):
        late.result(JOIN_TIMEOUT)
    assert late.cancelled()


def test_launch_error_reaches_the_request(dbs, monkeypatch):
    """A kernel launch that fails on the dispatcher thread fails the
    request with that error: nothing answers it from the host instead.
    (A pipeline's first query launches; later ones may answer from the
    engine's sorted-column indexes, so each leg takes a fresh pipeline.)"""
    for k in ("PREDTRACE_DEVICE_CUTOVER", "PREDTRACE_MEMBER_CUTOVER"):
        monkeypatch.setenv(k, "0")
    pt, fresh = (prep(PORT, dbs[PORT], "q3") for _ in range(2))
    real, calls = PORT.scan.pred_filter_batch, []

    def counted(*a, **kw):
        calls.append(threading.current_thread().name)
        return real(*a, **kw)

    def broken(*a, **kw):
        raise RuntimeError("pred_filter_batch kernel launch failed: cudaError 700")

    svc = PORT.service.LineageService({"q3": pt, "fresh": fresh},
                                      window_s=0.001, name="dispatcher")
    try:
        monkeypatch.setattr(PORT.scan, "pred_filter_batch", counted)
        want = svc.query(0, "q3", timeout=JOIN_TIMEOUT)
        assert calls and set(calls) == {"dispatcher"}
        monkeypatch.setattr(PORT.scan, "pred_filter_batch", broken)
        req = svc.submit(0, "fresh", timeout=JOIN_TIMEOUT)
        with pytest.raises(RuntimeError, match="cudaError 700"):
            req.result(JOIN_TIMEOUT)
        st = svc.stats()
        assert st["failed"] == 1 and st["answered"] == 1
    finally:
        svc.close()
    monkeypatch.setattr(PORT.scan, "pred_filter_batch", real)
    _same_answer(want, fresh.query(0))


def test_delta_extension_launch_error_reaches_the_request(monkeypatch):
    """A cached answer extended across an append rescans the appended
    partitions on the dispatcher thread; a launch that fails there fails the
    request with that error, and is neither answered from the host nor
    counted as a stale entry.  Submitting scans nothing on the client's
    thread."""
    pt = monotone_pt(PORT)
    real, calls = PORT.scan.pred_filter_batch, []

    def counted(*a, **kw):
        calls.append(threading.current_thread().name)
        return real(*a, **kw)

    def broken(*a, **kw):
        calls.append(threading.current_thread().name)
        raise RuntimeError("pred_filter_batch kernel launch failed: cudaError 700")

    svc = PORT.service.LineageService(pt, window_s=0.001, name="dispatcher")
    try:
        svc.query({"g": 19}, timeout=JOIN_TIMEOUT)
        pt.run_delta({"t": {"k": np.arange(1000, 1030), "g": np.full(30, 19),
                            "v": np.arange(30)}})
        monkeypatch.setattr(PORT.scan, "pred_filter_batch", broken)
        req = svc.submit({"g": 19}, timeout=JOIN_TIMEOUT)
        with pytest.raises(RuntimeError, match="cudaError 700"):
            req.result(JOIN_TIMEOUT)
        st = svc.stats()
        assert st["failed"] == st["answered"] == st["batches"] == 1
        assert st["delta_hits"] == st["cache_stale"] == 0
        monkeypatch.setattr(PORT.scan, "pred_filter_batch", counted)
        ext = svc.query({"g": 19}, timeout=JOIN_TIMEOUT)
        assert svc.stats()["delta_hits"] == 1
        assert ext.detail.get("cache") == "hit"
    finally:
        svc.close()
    assert calls and set(calls) == {"dispatcher"}
    monkeypatch.setattr(PORT.scan, "pred_filter_batch", real)
    _same_answer(ext, pt.query({"g": 19}))
    pt.close()


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _card_db():
    from repro_torch.tpch import generate

    return generate(sf=0.01, seed=1)


@pytest.mark.cuda
def test_cuda_query_delta_matches_cpu(cuda):
    from test_torch_incremental import sample_delta

    db = _card_db()
    delta = {"lineitem": sample_delta(db["lineitem"], db["lineitem"].nrows // 30,
                                      31)}
    got = {}
    for device in ("cpu", "cuda"):
        pt = PORT.lineage.PredTrace(dict(db), PORT.queries["q3"](db),
                                    store=True, partition_rows=4096,
                                    device=device)
        pt.infer()
        pt.run()
        tok0 = pt.answer_generation()
        cached = pt.query_batch(list(range(8)))
        pt.run_delta({k: dict(v) for k, v in delta.items()})
        got[device] = ([pt.query_delta(a, tok0) for a in cached],
                       pt.query_batch(list(range(8))))
        if device == "cuda":
            assert pt.scan_engine.stats.device_scans > 0
        pt.close()
    for a, b in zip(got["cpu"][1], got["cuda"][1]):
        _same_answer(a, b)
    for a, b in zip(got["cpu"][0], got["cuda"][0]):
        assert (a is None) == (b is None)
        if a is not None:
            _same_answer(a, b)


def _served_on_dispatcher(device, monkeypatch):
    """q3 and q12 served by a LineageService on ``device`` with the device
    cutovers at 0: answers equal the numpy backend's, and every scan launch
    of the serving run comes from the dispatcher thread.  Returns the
    launches as (thread, set variant) pairs."""
    db = _card_db()
    want, pts, rows = {}, {}, {}
    for q in ("q3", "q12"):
        ref = PORT.lineage.PredTrace(db, PORT.queries[q](db),
                                     scan_engine=PORT.scan.ScanEngine("numpy"))
        ref.infer()
        ref.run()
        rows[q] = list(range(min(16, ref.exec_result.output.nrows)))
        want[q] = ref.query_batch(rows[q])
        pts[q] = PORT.lineage.PredTrace(
            db, PORT.queries[q](db),
            scan_engine=PORT.scan.ScanEngine("torch", device=device,
                                             device_cutover=0))
        pts[q].infer()
        pts[q].run()
    real, calls = PORT.scan.pred_filter_batch, []

    def recorded(*a, **kw):
        calls.append((threading.current_thread().name,
                      bool(kw.get("set_cols"))))
        return real(*a, **kw)

    monkeypatch.setattr(PORT.scan, "pred_filter_batch", recorded)
    with PORT.service.LineageService(pts, max_batch=32, window_s=0.003,
                                     name="dispatcher") as svc:
        # a lone request first: query() launches on a fresh pipeline
        _same_answer(svc.query(0, "q3", timeout=JOIN_TIMEOUT), want["q3"][0])
        handles = {q: svc.submit_many(rows[q], q, timeout=JOIN_TIMEOUT)
                   for q in pts}
        for q, hs in handles.items():
            for h, w in zip(hs, want[q]):
                _same_answer(h.result(JOIN_TIMEOUT), w)
        assert svc.stats()["failed"] == 0
    assert calls and {t for t, _ in calls} == {"dispatcher"}
    return calls


def test_service_launches_from_its_dispatcher_thread(monkeypatch):
    _served_on_dispatcher("cpu", monkeypatch)


@pytest.mark.cuda
def test_cuda_service_answers_from_its_dispatcher_thread(cuda, monkeypatch):
    from repro_torch.kernels.pred_filter import LAUNCHES

    before = dict(LAUNCHES)
    calls = _served_on_dispatcher("cuda", monkeypatch)
    # each launch of the serving run ran the kernel, not its plain version
    n_sets = sum(1 for _, sets in calls if sets)
    assert LAUNCHES["cmp"] - before["cmp"] >= len(calls) - n_sets > 0
    assert LAUNCHES["sets"] - before["sets"] >= n_sets
