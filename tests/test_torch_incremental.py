"""The port's incremental runtime against the JAX package's.

The cases of ``tests/test_incremental.py``, each run through both packages
on the same seeded inputs: ``run_delta`` on partitioned and unpartitioned
catalogs (append-unsafe plans fall back to a full re-run), the
``DeltaReport``, ``answer_generation`` watermarks, ``query_delta`` against a
fresh ``query`` on the appended catalog, the service's warm delta hits, and
the store's encoded appends.  The port runs on ``device="cpu"`` with the
device cutovers forced to 0, so its scans go through the kernels' plain
PyTorch versions.  Lineage row sets, ``precise`` flags and counters must be
identical to the reference's.
"""

from __future__ import annotations

import importlib
import threading

import numpy as np
import pytest

from test_torch_lineage_tpch import CUTOVER_ENV, _as_numpy, _same_answer

SF, SEED = 0.002, 1


class Pkg:
    """One package's modules, with the port's entry points on the CPU."""

    def __init__(self, root: str):
        self.port = root == "repro_torch"
        for mod in ("ops", "expr", "table", "store", "executor", "lineage",
                    "scan", "service", "plan", "dispatch"):
            setattr(self, mod, importlib.import_module(f"{root}.core.{mod}"))
        self.store_io = importlib.import_module(f"{root}.checkpoint.store_io")
        self.queries = importlib.import_module(f"{root}.tpch").ALL_QUERIES

    def PredTrace(self, cat, plan, **kw):
        if self.port:
            kw.setdefault("device", "cpu")
        return self.lineage.PredTrace(cat, plan, **kw)

    def Executor(self, cat):
        if self.port:
            return self.executor.Executor(cat, device="cpu")
        return self.executor.Executor(cat)

    def ScanEngine(self):
        if self.port:
            return self.scan.ScanEngine("torch", device="cpu")
        return self.scan.ScanEngine()


REF, PORT = Pkg("repro"), Pkg("repro_torch")
BOTH = (REF, PORT)


@pytest.fixture(autouse=True)
def forced_device(monkeypatch):
    for k in CUTOVER_ENV:
        monkeypatch.setenv(k, "0")


@pytest.fixture(scope="module")
def dbs():
    from repro.tpch import generate

    ref = generate(sf=SF, seed=SEED)
    return {REF: ref,
            PORT: PORT.table.catalog_from_numpy(_as_numpy(ref), device="cpu")}


def lineage_sets(ans):
    return {k: set(np.asarray(v).tolist()) for k, v in ans.items() if len(v)}


def sample_delta(t, k: int, seed: int):
    """Appended rows: k existing rows resampled (dict columns as codes)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, t.nrows, k)
    return {c: np.asarray(t.cols[c])[idx] for c in t.columns}


def grow(pkg, base, delta_cols):
    """Cold grown table: plain concatenation, no delta machinery."""
    k = len(next(iter(delta_cols.values())))
    cols = {}
    for c, v in base.cols.items():
        v = np.asarray(v)
        if c == pkg.table.RID:
            cols[c] = np.arange(base.nrows + k, dtype=v.dtype)
        else:
            cols[c] = np.concatenate([v, np.asarray(delta_cols[c]).astype(v.dtype)])
    return pkg.table.Table(cols, dict(base.dicts), base.name)


def row_values(pt, i=0):
    out = pt.exec_result.output
    return {c: out.cols[c][i] for c in out.columns}


def monotone_catalog(pkg, n=1000, group_rows=50):
    k = np.arange(n)
    return {"t": pkg.table.Table.from_dict(
        {"k": k, "g": k // group_rows, "v": (k * 7) % 100}, name="t")}


def monotone_plan(pkg):
    O, Col = pkg.ops, pkg.expr.Col
    return O.GroupBy(O.Filter(O.Source("t"), Col("v") >= 0), ["g"],
                     {"sv": O.Agg("sum", Col("v"))})


def monotone_delta(n0, k, group_rows=50):
    kk = np.arange(n0, n0 + k)
    return {"k": kk, "g": kk // group_rows, "v": (kk * 7) % 100}


def monotone_pt(pkg):
    pt = pkg.PredTrace(monotone_catalog(pkg), monotone_plan(pkg), store=True,
                       partition_rows=100)
    pt.infer()
    pt.run()
    return pt


def norm_token(tok):
    """An answer_generation token without the process-wide counters and
    plan-node ids: the row watermarks, stages in node order."""
    _, marks = tok
    return tuple(m[2] if m[0] == "s" else m for m in marks)


def report_view(rep):
    """A DeltaReport without node ids or timings (stages in node order)."""
    d = rep.to_dict()
    return (d["appended"],
            [(s["action"], s["reason"] and s["reason"].split(": ", 1)[1],
              s["delta_rows"]) for _, s in sorted(d["stages"].items())],
            d["output_action"], d["output_reason"] is None,
            d["full_invalidation"])


# --------------------------------------------------------------------------- #
# run_delta differentials over TPC-H (q3: join + group-by stages)
# --------------------------------------------------------------------------- #

CONFIGS = [
    # (store, budget_bytes, partition_rows)
    (True, None, None),
    (True, None, 256),
    (True, 0, None),
    (True, 0, 256),
    (True, 1 << 13, None),
    (True, 1 << 13, 256),
    (False, None, None),
    (False, None, 256),
]


@pytest.mark.parametrize("store,budget,part", CONFIGS)
def test_tpch_delta_matches_reference(dbs, store, budget, part):
    ref_db = dbs[REF]
    deltas = {
        "lineitem": sample_delta(ref_db["lineitem"],
                                 max(ref_db["lineitem"].nrows // 30, 1), 11),
        "orders": sample_delta(ref_db["orders"],
                               max(ref_db["orders"].nrows // 30, 1), 12),
    }
    got = {}
    for pkg in BOTH:
        db = dbs[pkg]
        plan = pkg.queries["q3"](db)
        grown = dict(db)
        for name, dc in deltas.items():
            grown[name] = grow(pkg, db[name], dc)
        cold = pkg.PredTrace(dict(grown), plan)
        cold.infer()
        cold.run()
        row = row_values(cold)
        pt = pkg.PredTrace(dict(db), plan, store=store or None,
                           budget_bytes=budget, partition_rows=part)
        pt.infer()
        pt.run()
        tok0 = norm_token(pt.answer_generation())
        res = pt.run_delta(deltas)
        got[pkg] = (pt.query(row), cold.query(row), report_view(res.delta),
                    tok0, norm_token(pt.answer_generation()))
        pt.close()
    (ans, cold_ans, rep, tok0, tok1), ref = got[PORT], got[REF]
    _same_answer(ans, ref[0])
    assert (rep, tok0, tok1) == ref[2:]
    if budget is None:
        assert lineage_sets(ans.lineage) == lineage_sets(cold_ans.lineage)
    # q3's stages sit under joins and group-bys: append-unsafe, re-run
    assert rep[4] == any(a == "rerun" for a, _, _ in rep[1])


def test_tpch_delta_q10_matches_reference(dbs):
    ref_db = dbs[REF]
    deltas = {"lineitem": sample_delta(ref_db["lineitem"],
                                       ref_db["lineitem"].nrows // 25, 21)}
    got = {}
    for pkg in BOTH:
        db = dbs[pkg]
        plan = pkg.queries["q10"](db)
        pt = pkg.PredTrace(dict(db), plan, store=True, partition_rows=256)
        pt.infer()
        pt.run()
        res = pt.run_delta(deltas)
        got[pkg] = [pt.query(r) for r in range(3)], report_view(res.delta)
        pt.close()
    for a, b in zip(got[PORT][0], got[REF][0]):
        _same_answer(a, b)
    assert got[PORT][1] == got[REF][1]


def test_query_delta_matches_fresh_query(dbs):
    ref_db = dbs[REF]
    deltas = {"lineitem": sample_delta(ref_db["lineitem"],
                                       ref_db["lineitem"].nrows // 30, 31)}
    got = {}
    for pkg in BOTH:
        db = dbs[pkg]
        pt = pkg.PredTrace(dict(db), pkg.queries["q3"](db), store=True,
                           partition_rows=256)
        pt.infer()
        pt.run()
        row = row_values(pt)
        tok0 = pt.answer_generation()
        ans0 = pt.query(row)
        assert ans0.delta_ctx is not None
        pt.run_delta(deltas)
        assert pkg.lineage.delta_compatible(tok0, pt.answer_generation())
        got[pkg] = pt.query_delta(ans0, tok0), pt.query(row)
        pt.close()
    (ext, fresh), (ref_ext, ref_fresh) = got[PORT], got[REF]
    _same_answer(fresh, ref_fresh)
    assert (ext is None) == (ref_ext is None)
    if ext is not None:
        assert lineage_sets(ext.lineage) == lineage_sets(fresh.lineage)
        _same_answer(ext, ref_ext)
        assert ext.detail["delta"] == ref_ext.detail["delta"]


def test_appended_matching_row_is_found(dbs):
    got = {}
    for pkg in BOTH:
        db = dbs[pkg]
        pt = pkg.PredTrace(dict(db), pkg.queries["q3"](db), store=True,
                           partition_rows=256)
        pt.infer()
        pt.run()
        row = row_values(pt)
        ans0 = pt.query(row)
        li = db["lineitem"]
        src = int(np.asarray(ans0.lineage["lineitem"])[0])
        delta = {c: np.asarray(li.cols[c])[[src]] for c in li.columns}
        new_rid = pt.catalog["lineitem"].nrows
        pt.run_delta({"lineitem": delta})
        ans1 = pt.query(row)
        assert new_rid in set(np.asarray(ans1.lineage["lineitem"]).tolist())
        got[pkg] = ans1
        pt.close()
    _same_answer(got[PORT], got[REF])


# --------------------------------------------------------------------------- #
# warm extension: rescanned vs warm partitions, service delta hits
# --------------------------------------------------------------------------- #

def _extend(pkg, group, delta):
    pt = monotone_pt(pkg)
    tok0 = pt.answer_generation()
    if group == "last":
        group = int(np.asarray(pt.catalog["t"].cols["g"]).max())
    ans0 = pt.query({"g": group})
    pt.run_delta({"t": delta})
    ext = pt.query_delta(ans0, tok0)
    out = (ext, ans0, pt.catalog["t"].num_partitions,
           pt.scan_engine.stats.device_scans)
    pt.close()
    return out


@pytest.mark.parametrize("case", ["unaffected", "affected"])
def test_query_delta_rescans_match_reference(case):
    if case == "unaffected":
        group, delta = 0, monotone_delta(1000, 50)
    else:
        group, delta = "last", {"k": np.arange(1000, 1030),
                                "g": np.full(30, 19), "v": np.arange(30)}
    got = {pkg: _extend(pkg, group, delta) for pkg in BOTH}
    (ext, ans0, total, _), (ref_ext, _, _, _) = got[PORT], got[REF]
    assert ext is not None and ref_ext is not None
    _same_answer(ext, ref_ext)
    d = ext.detail["delta"]
    assert d == ref_ext.detail["delta"]
    if case == "unaffected":
        assert d["rescanned_partitions"] == 0 and d["warm_partitions"] > 0
        assert lineage_sets(ext.lineage) == lineage_sets(ans0.lineage)
    else:
        assert 0 < d["rescanned_partitions"] < total
        assert set(range(1000, 1030)) <= set(np.asarray(ext.lineage["t"]).tolist())


def test_delta_rescan_goes_through_the_kernel():
    """The appended partitions' scan takes the engine's device route: with
    the cutovers at 0 the port counts a device scan for it."""
    pt = monotone_pt(PORT)
    tok0 = pt.answer_generation()
    ans0 = pt.query({"g": 19})
    pt.run_delta({"t": {"k": np.arange(1000, 1030), "g": np.full(30, 19),
                        "v": np.arange(30)}})
    before = pt.scan_engine.stats.device_scans
    assert pt.query_delta(ans0, tok0) is not None
    assert pt.scan_engine.stats.device_scans > before
    pt.close()


def test_delta_view_slabs_stay_bounded():
    """Each append makes new delta views (new uids); the backend's slab
    cache keeps at most SLAB_CACHE of them, dropping the oldest."""
    pt = monotone_pt(PORT)
    be = pt.scan_engine.backend
    cap = be.SLAB_CACHE
    seen = set()
    for i in range(cap + 8):
        tok0 = pt.answer_generation()
        ans0 = pt.query({"g": 19})
        pt.run_delta({"t": {"k": np.arange(1000 + i, 1001 + i),
                            "g": np.full(1, 19), "v": np.full(1, i)}})
        assert pt.query_delta(ans0, tok0) is not None
        seen |= set(be._slabs._d)
        assert len(be._slabs) <= cap
    assert len(seen) > cap
    pt.close()


SERVICE_COUNTERS = ("cache_hits", "cache_misses", "cache_stale", "delta_hits",
                    "answered", "batches", "batch_queries")


def _service_delta(pkg, rerun: bool):
    pt = monotone_pt(pkg)
    answers = []
    with pkg.service.LineageService(pt) as svc:
        answers.append(svc.query({"g": 0}))
        if rerun:
            pt.run()
        else:
            pt.run_delta({"t": monotone_delta(1000, 50)})
        answers.append(svc.query({"g": 0}))
        answers.append(svc.query({"g": 0}))
        st = svc.stats()
    pt.close()
    return answers, {k: st[k] for k in SERVICE_COUNTERS}


@pytest.mark.parametrize("rerun", [False, True], ids=["append", "rerun"])
def test_service_across_delta_matches_reference(rerun):
    got = {pkg: _service_delta(pkg, rerun) for pkg in BOTH}
    for a, b in zip(got[PORT][0], got[REF][0]):
        _same_answer(a, b)
        assert a.detail.get("cache") == b.detail.get("cache")
    assert got[PORT][1] == got[REF][1]
    if rerun:
        assert got[PORT][1]["delta_hits"] == 0
        assert got[PORT][1]["cache_stale"] >= 1
    else:
        assert got[PORT][1]["delta_hits"] >= 1
        assert got[PORT][1]["cache_stale"] == 0


def test_generation_race_drops_insert():
    pt = monotone_pt(PORT)
    svc = PORT.service.LineageService(pt, window_s=0.001)
    try:
        in_hook, release = threading.Event(), threading.Event()

        def hook(key):
            in_hook.set()
            release.wait(10)

        svc._pre_query_hook = hook
        req = svc.submit({"g": 0})
        assert in_hook.wait(10), "dispatcher never reached the query"
        pt.run_delta({"t": monotone_delta(1000, 50)})
        release.set()
        ans = req.result(10)
        assert svc.stats.cache_race_drops >= 1
        before = svc.stats.cache_hits
        fresh = svc.query({"g": 0})
        assert svc.stats.cache_hits == before
        assert lineage_sets(fresh.lineage) == lineage_sets(ans.lineage)
    finally:
        svc._pre_query_hook = None
        svc.close()
        pt.close()


# --------------------------------------------------------------------------- #
# uid-keyed caches, degenerate zone maps, empty deltas
# --------------------------------------------------------------------------- #

def test_engine_caches_correct_under_id_reuse():
    eng = PORT.ScanEngine()
    pred = PORT.expr.Col("v") >= 90
    for i in range(40):
        t = PORT.table.partition_table(
            PORT.table.Table.from_dict({"v": np.arange(100) + i}, name="t"),
            part_rows=None, num_partitions=None)
        assert int(eng.scan(pred, t, {}).sum()) == min(10 + i, 100), i
        del t
    assert eng.stats.device_scans > 0


def test_uids_and_sorted_set_cache():
    T = PORT.table
    t = T.Table.from_dict({"v": np.arange(10)}, name="t")
    st = PORT.store.IntermediateStore(None).put(1, t)
    assert st.uid != t.uid
    assert T.table_uid(st) == st.uid and T.table_uid(t) == t.uid
    v = np.array([5, 3, 3, 1])
    assert PORT.scan._sorted_unique(v).tolist() == [1, 3, 5]
    k = id(v)
    assert PORT.scan._SORTED_SETS.get(k) is not None
    del v
    assert PORT.scan._SORTED_SETS.get(k) is None


@pytest.mark.parametrize("case", ["zero_length", "all_nan"])
def test_zone_maps_on_degenerate_partitions(case):
    if case == "zero_length":
        cols, part, n = {"v": np.arange(20, dtype=np.int64)}, 10, 25
    else:
        cols = {"v": np.concatenate([np.arange(10.0), np.full(10, np.nan)])}
        part, n = 10, 20
    zms = [pkg.table.build_zone_maps(cols, part, n) for pkg in BOTH]
    assert zms[0].n_partitions == zms[1].n_partitions
    for stat in ("lo", "hi", "nulls", "distinct"):
        assert np.array_equal(getattr(zms[0], stat)["v"],
                              getattr(zms[1], stat)["v"], equal_nan=True), stat


def test_empty_deltas_are_noops():
    T = PORT.table
    pt = T.partition_table(monotone_catalog(PORT)["t"], num_partitions=None,
                           part_rows=100)
    assert pt.append_partition(
        T.Table.from_dict({"k": [], "g": [], "v": []}, name="t")) is pt
    trace = monotone_pt(PORT)
    tok0 = trace.answer_generation()
    res = trace.run_delta({"t": {"k": [], "g": [], "v": []}})
    assert res.delta.output_action == "unchanged"
    assert trace.answer_generation() == tok0
    trace.close()


def test_answer_generation_watermarks_match_reference():
    toks = {}
    for pkg in BOTH:
        pt = monotone_pt(pkg)
        t0 = pt.answer_generation()
        pt.run_delta({"t": monotone_delta(1000, 50)})
        t1 = pt.answer_generation()
        pt.run()
        t2 = pt.answer_generation()
        assert t0[0] == t1[0] != t2[0]  # appends keep the base, runs bump it
        toks[pkg] = [norm_token(t) for t in (t0, t1, t2)]
        pt.close()
    assert toks[PORT] == toks[REF]


@pytest.mark.parametrize("old,new", [
    ("old", "old"), ("old", "grown"), ("old", "rebased"), ("old", "shrunk"),
    ("old", "fewer"), ("bare", "old")])
def test_delta_compatible_matches_reference(old, new):
    base = (3, 7)
    tokens = {
        "old": (base, (("s", 1, 100), ("t", "a", 500))),
        "grown": (base, (("s", 1, 120), ("t", "a", 500))),
        "rebased": ((4, 7), (("s", 1, 120), ("t", "a", 500))),
        "shrunk": (base, (("s", 1, 90), ("t", "a", 500))),
        "fewer": (base, (("t", "a", 500),)),
        "bare": (1, 2),
    }
    want = REF.lineage.delta_compatible(tokens[old], tokens[new])
    assert PORT.lineage.delta_compatible(tokens[old], tokens[new]) is want


# --------------------------------------------------------------------------- #
# the store's append path
# --------------------------------------------------------------------------- #

def _append_cases():
    rng = np.random.default_rng(5)
    return [rng.standard_normal(500), np.repeat(rng.integers(0, 4, 20), 25),
            rng.integers(1000, 1010, 500), rng.random(500) < 0.5,
            np.round(rng.standard_normal(500), 2)]


@pytest.mark.parametrize("case", range(5))
def test_append_encoded_matches_reference(case):
    base = np.asarray(_append_cases()[case])
    for tail in (base[:37], base[:0], base[::-1][:53]):
        outs = [pkg.store.append_encoded(pkg.store.encode_column(base), tail)
                for pkg in BOTH]
        assert outs[0].kind == outs[1].kind
        want = np.concatenate([base, tail])
        for out in outs:
            np.testing.assert_array_equal(out.decode(), want)


def test_delta_column_fast_append_matches_reference():
    rng = np.random.default_rng(3)
    base = np.sort(rng.integers(0, 10_000, 1000)).astype(np.int64)
    tails = [base[-1] + np.sort(rng.integers(0, 500, 137)),
             np.array([], dtype=np.int64), base[-1] + np.arange(64),
             np.sort(rng.integers(0, 100, 50)).astype(np.int64)]
    for tail in tails:
        outs = [pkg.store.append_encoded(
            pkg.store.DeltaColumn.encode(base, np.int16), tail) for pkg in BOTH]
        assert type(outs[0]).__name__ == type(outs[1]).__name__
        for out in outs:
            np.testing.assert_array_equal(out.decode(),
                                          np.concatenate([base, tail]))
    outs = [pkg.store.append_encoded(
        pkg.store.DeltaColumn.encode(np.arange(100, dtype=np.int64), np.int8),
        np.array([100, 50_100], dtype=np.int64)) for pkg in BOTH]
    assert not isinstance(outs[1], PORT.store.DeltaColumn)
    assert outs[0].kind == outs[1].kind


def test_put_delta_matches_reference():
    got = {}
    for pkg in BOTH:
        rng = np.random.default_rng(7)
        T = pkg.table.Table
        t = T.from_dict({"a": rng.integers(0, 50, 1000),
                         "b": rng.standard_normal(1000)}, name="s")
        store = pkg.store.IntermediateStore(None, part_rows=100)
        zm0 = store.put(3, t).zone_maps
        gen = store.generation
        st1 = store.put_delta(3, T.from_dict(
            {"a": rng.integers(0, 50, 150), "b": rng.standard_normal(150)},
            name="s"))
        assert store.generation == gen
        np.testing.assert_array_equal(st1.zone_maps.lo["a"][:10],
                                      zm0.lo["a"][:10])
        got[pkg] = (st1, dict(store.delta_stats))
    (st, stats), (ref_st, ref_stats) = got[PORT], got[REF]
    assert stats == ref_stats and st.nrows == ref_st.nrows == 1150
    assert st.encodings() == ref_st.encodings()
    for c in ("a", "b"):
        np.testing.assert_array_equal(st.enc[c].decode(), ref_st.enc[c].decode())
        for stat in ("lo", "hi", "nulls"):
            np.testing.assert_array_equal(getattr(st.zone_maps, stat)[c],
                                          getattr(ref_st.zone_maps, stat)[c])


# --------------------------------------------------------------------------- #
# executor classification and the explain surface
# --------------------------------------------------------------------------- #

def _classify(pkg):
    O, Col, T = pkg.ops, pkg.expr.Col, pkg.table.Table
    k = np.arange(200)
    cat = {"t": T.from_dict({"k": k, "g": k % 5, "v": k * 3}, name="t"),
           "u": T.from_dict({"x": np.arange(50)}, name="u")}
    filt = O.Filter(O.Source("t"), Col("v") > 30)
    gb = O.GroupBy(filt, ["g"], {"sv": O.Agg("sum", Col("v"))})
    untouched = O.Filter(O.Source("u"), Col("x") > 10)
    plan = O.Union([O.Project(gb, ["g"]),
                    O.Project(O.GroupBy(untouched, [],
                                        {"g": O.Agg("count", Col("x"))}),
                              ["g"])])
    mat = {filt.id: None, gb.id: None, untouched.id: None}
    store = pkg.store.IntermediateStore(None)
    ex = pkg.Executor(cat)
    prev = ex.run(plan, materialize=mat, store=store)
    gen0 = ex.run_generation
    delta = pkg.table.encode_delta_like(cat["t"], {"k": [200, 201],
                                                   "g": [1, 2], "v": [600, 603]})
    res = ex.run_delta(plan, {"t": delta}, materialize=mat, store=store,
                       prev=prev)
    acts = {nid: sd.action for nid, sd in res.delta.stages.items()}
    assert acts == {filt.id: "extended", gb.id: "rerun",
                    untouched.id: "untouched"}
    assert ex.run_generation != gen0
    out = res.output
    return (report_view(res.delta),
            {c: np.asarray(out.cols[c]).tolist() for c in out.columns},
            {c: np.asarray(v).tolist() for c, v in
             store.stages[filt.id].to_table().cols.items()})


def test_run_delta_classification_matches_reference():
    assert _classify(PORT) == _classify(REF)


def test_explain_delta_report_matches_reference():
    got = {}
    for pkg in BOTH:
        pt = monotone_pt(pkg)
        pt.run_delta({"t": monotone_delta(1000, 50)})
        d = pt.explain({"g": 0}).to_dict()["pipeline"]["delta"]
        d["output_reason"] = d["output_reason"].split(": ", 1)[1]
        got[pkg] = ({k: v for k, v in d.items() if k not in ("seconds",
                                                              "stages")},
                    [(s["action"], s["delta_rows"])
                     for _, s in sorted(d["stages"].items())])
        pt.close()
    assert got[PORT] == got[REF]
    assert got[PORT][0]["appended"] == {"t": 50} and "store" in got[PORT][0]
