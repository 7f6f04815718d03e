"""The port's out-of-core store tier against the JAX package's.

The four guarantees of ``tests/test_oocore.py``, through both packages on
the same seeded inputs:

1. ``demote()`` / ``promote()`` are bit-exact and do not bump the store
   generation; zone maps stay in RAM.
2. In-situ scans of a disk-tier stage give the same mask as a scan of the
   raw table — on the port's host path and on its device route (the
   kernel's plain version here, the kernel on the card).
3. The two-tier planner demotes before it drops.
4. With ``budget_bytes=0`` and ``disk_budget_bytes=None`` every TPC-H query
   is precise and identical to the RAM path.

Spill roots (the store's and the disk probe's) go under ``tmp_path``.
"""

from __future__ import annotations

import gc
import os
import tempfile
import warnings

import numpy as np
import pytest
import torch

from test_torch_incremental import BOTH, PORT, REF
from test_torch_lineage_tpch import CUTOVER_ENV, _as_numpy, _same_answer

SF, SEED = 0.002, 1


@pytest.fixture(autouse=True)
def spill_under_tmp(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


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


def scan_table(pkg, n):
    rng = np.random.default_rng(11)
    return pkg.table.Table.from_dict({
        "a": rng.integers(0, 50, n).astype(np.int32),
        "b": np.sort(rng.integers(0, 10**7, n)).astype(np.int64),
        "c": rng.integers(0, 200, n).astype(np.int64),
        "d": rng.normal(size=n),
        "e": np.round(rng.uniform(0, 100, n) * 100) / 100,
    }, name="t")


def preds(pkg, t):
    E = pkg.expr
    Col, Param = E.Col, E.Param
    n = t.nrows
    return [
        (Col("a") >= 10, {}),
        (E.land(Col("b").eq(Param("v")), Col("c") < 100),
         {"v": int(t.cols["b"][n // 2])}),
        (Col("b").eq(Param("v")), {"v": t.cols["b"][:50]}),
        (E.IsIn(Col("a"), (1, 2, 3)), {}),
        (E.land(Col("a") < Col("c"), Col("b") >= 5 * 10**6), {}),
        (E.lor(Col("a") < 2, Col("c") > 190), {}),
        (Col("e").eq(Param("w")), {"w": float(t.cols["e"][17])}),
    ]


def decoded(st):
    return {c: np.array(v, copy=True) for c, v in st.to_table(cache=False).cols.items()}


# --------------------------------------------------------------------------- #
# 1. demote / promote
# --------------------------------------------------------------------------- #

def test_demote_promote_roundtrip_matches_reference():
    got = {}
    for pkg in BOTH:
        store = pkg.store.IntermediateStore(part_rows=1000)
        store.put(1, scan_table(pkg, 4000))
        gen, ram = store.generation, decoded(store.get(1))
        st = store.demote(1)
        assert st.tier == "disk" and store.disk_stages() == [1]
        assert store.generation == gen
        assert st.zone_maps is store.get(1).zone_maps
        disk = decoded(st)
        st2 = store.promote(1)
        assert st2.tier == "ram" and store.generation == gen
        back = decoded(st2)
        for c in ram:
            assert np.array_equal(disk[c], ram[c], equal_nan=True), c
            assert np.array_equal(back[c], ram[c], equal_nan=True), c
        summ = store.tier_summary()
        got[pkg] = (ram, summ, st2.encodings())
        store.close()
    ram, summ, encs = got[PORT]
    assert summ == got[REF][1] and encs == got[REF][2]
    assert summ["disk_stages"] == [] and summ["disk_bytes"] == 0
    for c, v in ram.items():
        assert np.array_equal(v, got[REF][0][c], equal_nan=True), c


def test_demote_idempotent_promote_noop_close_removes_root(tmp_path):
    store = PORT.store.IntermediateStore()
    store.put(1, scan_table(PORT, 500))
    store.demote(1)
    store.demote(1)
    assert store.tier_stats["demotions"] == 1
    root = store._spill_dir
    assert root is not None and os.path.isdir(root)
    assert os.path.commonpath([root, str(tmp_path)]) == str(tmp_path)
    store.promote(1)
    store.promote(1)
    assert store.tier_stats["promotions"] == 1
    store.close()
    assert not os.path.exists(root)


def test_tier_move_frees_the_old_stages_slab(forced_device):
    """demote()/promote() replace the StoredTable: the backend's slab of the
    old object must go with it, so device memory never holds both."""
    eng = PORT.ScanEngine()
    store = PORT.store.IntermediateStore()
    store.put(1, scan_table(PORT, 4096))
    prog = eng.compile(PORT.expr.Col("a") >= 10)
    slabs = eng.backend._slabs
    for move in (store.demote, store.promote):
        st = store.get(1)
        assert eng.backend.scan_stored(prog, st, {}, force=True) is not None
        old = ("stored", st.uid)
        assert slabs.get(old) is not None
        del st
        move(1)
        gc.collect()
        assert slabs.get(old) is None, move.__name__
    store.close()


# --------------------------------------------------------------------------- #
# 2. disk-tier scans == scans of the raw table
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("part_rows", [None, 1024])
def test_disk_tier_insitu_matches_raw_scan(part_rows):
    masks = {}
    for pkg in BOTH:
        t = scan_table(pkg, 8000)
        store = pkg.store.IntermediateStore(part_rows=part_rows)
        store.put(1, t)
        st = store.demote(1)
        if part_rows:
            assert st.zone_maps is not None and st.zone_maps.n_partitions > 1
        eng, be = pkg.ScanEngine(), pkg.store.InSituBackend()
        masks[pkg] = []
        for pred, binding in preds(pkg, t):
            got = be.scan(eng.compile(pred), st, binding)
            assert np.array_equal(got, eng.scan(pred, t, binding)), pred
            masks[pkg].append(got)
        store.close()
    for a, b in zip(masks[PORT], masks[REF]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_store_scan_of_disk_stage(backend, forced_device):
    """The numpy engine takes ``disk_insitu``, as the reference does; the
    torch engine with the cutovers at 0 may take the device route, which
    uploads the memmapped lanes.  Neither decodes the stage."""
    t = scan_table(PORT, 8000)
    store = PORT.store.IntermediateStore()
    store.put(1, t)
    store.demote(1)
    eng = (PORT.scan.ScanEngine("numpy") if backend == "numpy"
           else PORT.ScanEngine())
    for pred, binding in preds(PORT, t):
        got = store.scan(1, pred, binding, eng)
        assert np.array_equal(got, eng.scan(pred, t, binding)), pred
    st = eng.stats
    assert st.decode_chosen == 0
    assert st.disk_insitu_chosen >= (1 if backend == "numpy" else 0)
    if backend == "torch":
        assert st.disk_insitu_chosen + st.device_chosen == len(preds(PORT, t))
    assert store.get(1).tier == "disk" and store.get(1)._table is None
    store.close()


def test_device_route_on_disk_stage_uploads_memmap_lanes(forced_device):
    t = scan_table(PORT, 5000)
    store = PORT.store.IntermediateStore()
    store.put(1, t)
    st = store.demote(1)
    assert isinstance(st.enc["a"].values if st.enc["a"].kind == "plain"
                      else next(iter(st.enc["a"].state()[1].values())),
                      np.memmap)
    eng = PORT.ScanEngine()
    prog = eng.compile(PORT.expr.Col("a") >= 10)
    # the read-only memmaps upload without torch's non-writable warning
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = eng.backend.scan_stored(prog, st, {}, force=True)
    assert np.array_equal(got, np.asarray(t.cols["a"]) >= 10)
    assert eng.stats.device_scans == 1
    store.close()


def test_put_delta_on_disk_stage_then_scan():
    t, t2 = scan_table(PORT, 3000), scan_table(PORT, 4000)
    delta = PORT.table.Table.from_dict(
        {c: np.asarray(v)[3000:] for c, v in t2.cols.items()}, name="t")
    store = PORT.store.IntermediateStore()
    store.put(1, t)
    store.demote(1)
    st2 = store.put_delta(1, delta)
    assert st2.nrows == 4000 and st2.tier == "ram"
    ft = PORT.table.Table.from_dict(
        {c: np.concatenate([np.asarray(t.cols[c]), np.asarray(delta.cols[c])])
         for c in t.cols}, name="t")
    eng, be = PORT.ScanEngine(), PORT.store.InSituBackend()
    for pred, binding in preds(PORT, t):
        assert np.array_equal(be.scan(eng.compile(pred), st2, binding),
                              eng.scan(pred, ft, binding)), pred
    store.close()


def test_device_route_survives_append(forced_device):
    n = 4096
    t = scan_table(PORT, n)
    store = PORT.store.IntermediateStore()
    store.put(1, t)
    eng = PORT.ScanEngine()
    prog = eng.compile(PORT.expr.Col("a") >= 10)
    got1 = eng.backend.scan_stored(prog, store.get(1), {}, force=True)
    assert np.array_equal(got1, np.asarray(t.cols["a"]) >= 10)
    delta = PORT.table.Table.from_dict(
        {c: np.asarray(v)[: n // 4] for c, v in t.cols.items()}, name="t")
    st2 = store.put_delta(1, delta)
    got2 = eng.backend.scan_stored(prog, st2, {}, force=True)
    assert np.array_equal(got2, np.concatenate(
        [np.asarray(t.cols["a"]) >= 10, np.asarray(delta.cols["a"]) >= 10]))
    assert eng.stats.device_scans == 2
    store.close()


# --------------------------------------------------------------------------- #
# 3. the two-tier planner
# --------------------------------------------------------------------------- #

def planned(pkg, db, qname, **kw):
    plan = pkg.queries[qname](db)
    res = pkg.Executor(db).run(plan)
    pt = pkg.PredTrace(db, plan, store=True, **kw)
    pt.infer(stats=res.stats)
    pt.run()
    return pt, res


def plan_view(pt):
    """The materialization plan with stages by rank, not node id."""
    mp = pt.mat_plan
    order = sorted(mp.sizes)
    rank = {nid: i for i, nid in enumerate(order)}
    return ([rank[n] for n in mp.kept], [rank[n] for n in mp.disk],
            sorted(rank[n] for n in mp.dropped), mp.disk_bytes,
            [mp.sizes[n] for n in order])


@pytest.mark.parametrize("disk", ["unlimited", "off", "one_stage"])
def test_planner_matches_reference(dbs, disk):
    got = {}
    for pkg in BOTH:
        db = dbs[pkg]
        if disk == "one_stage":
            probe, _ = planned(pkg, db, "q3", budget_bytes=0,
                               disk_budget_bytes=None)
            mp = probe.mat_plan
            kw = dict(disk_budget_bytes=mp.sizes[mp.disk[0]])
            probe.close()
        else:
            kw = dict(disk_budget_bytes=None if disk == "unlimited" else 0)
        pt, _ = planned(pkg, db, "q3", budget_bytes=0, **kw)
        assert set(pt.store.disk_stages()) == set(pt.mat_plan.disk)
        got[pkg] = plan_view(pt)
        pt.close()
    kept, on_disk, dropped, disk_bytes, sizes = got[PORT]
    assert got[PORT] == got[REF]
    assert all(sizes[r] == 0 for r in kept)
    if disk == "unlimited":
        assert on_disk and not dropped and disk_bytes > 0
    elif disk == "off":
        assert on_disk == [] and dropped
    else:
        assert on_disk and disk_bytes == sizes[on_disk[0]]


def test_planner_unit_two_tier():
    got = {}
    for pkg in BOTH:
        P = pkg.plan
        lp = P.LineagePlan.__new__(P.LineagePlan)
        lp.stages = [P.Stage(node_id=i, run_pred=pkg.expr.Col("x") > 0,
                             params_out={}) for i in (1, 2, 3)]
        sizes = {1: 100, 2: 100, 3: 100}
        got[pkg] = [
            (mp.kept, mp.disk, sorted(mp.dropped), mp.disk_bytes)
            for mp in (P.plan_materialization(lp, sizes, budget_bytes=b,
                                              disk_budget_bytes=d)
                       for b, d in ((100, 100), (None, 0), (0, None)))]
    assert got[PORT] == got[REF]
    assert got[PORT] == [([1], [2], [3], 100), ([1, 2, 3], [], [], 0),
                         ([], [1, 2, 3], [], 300)]


# --------------------------------------------------------------------------- #
# 4. every TPC-H query precise at RAM budget 0 with unlimited disk
# --------------------------------------------------------------------------- #

QUERIES = sorted(PORT.queries, key=lambda q: int(q[1:]))


@pytest.mark.parametrize("qname", QUERIES)
def test_budget_zero_disk_unlimited_precise(dbs, forced_device, qname):
    answers = {}
    for pkg in BOTH:
        db = dbs[pkg]
        plan = pkg.queries[qname](db)
        res = pkg.Executor(db).run(plan)
        n = min(3, res.output.nrows)
        for tier in ("ram", "disk"):
            kw = (dict(budget_bytes=0, disk_budget_bytes=None)
                  if tier == "disk" else {})
            with pkg.PredTrace(db, plan, store=True, **kw) as pt:
                pt.infer(stats=res.stats)
                pt.run()
                if tier == "disk":
                    assert pt.precision_token()[1] == ()
                    assert set(pt.store.disk_stages()) == set(pt.mat_plan.disk)
                    # only empty stages (0 bytes) fit a RAM budget of 0
                    assert all(pt.mat_plan.sizes[n] == 0
                               for n in pt.mat_plan.kept)
                answers[pkg, tier] = [pt.query(r) for r in range(n)]
    for key in ((PORT, "disk"), (REF, "disk"), (REF, "ram")):
        assert len(answers[key]) == len(answers[PORT, "ram"])
        for a, b in zip(answers[key], answers[PORT, "ram"]):
            _same_answer(a, b)
    for a, b in zip(answers[PORT, "disk"], answers[PORT, "ram"]):
        assert a.all_precise() == b.all_precise()


def test_disk_tier_explain_and_generation(dbs, forced_device):
    db = dbs[PORT]
    pt, _ = planned(PORT, db, "q3", budget_bytes=0, disk_budget_bytes=None)
    pipe = pt.explain(0).pipeline
    assert pipe["disk_budget_bytes"] is None and pipe["stages_disk"]
    assert pipe["tiers"]["disk_stages"] == pt.store.disk_stages()
    gen = pt.answer_generation()
    for nid in list(pt.store.stages):
        pt.store.promote(nid)
    assert pt.answer_generation() == gen
    for nid in list(pt.store.stages):
        pt.store.demote(nid)
    assert pt.answer_generation() == gen
    pt.close()


def test_service_tier_residency_matches_reference(dbs, forced_device):
    got = {}
    for pkg in BOTH:
        pt, _ = planned(pkg, dbs[pkg], "q3", budget_bytes=0,
                        disk_budget_bytes=None)
        svc = pkg.service.LineageService(pt)
        try:
            ans = svc.submit(0).result(timeout=60)
            assert ans.all_precise()
            st = svc.stats()
            tiers = st["store_tiers"]["default"]
            got[pkg] = (ans, st["disk_tier_answers"], len(tiers["disk_stages"]),
                        tiers["ram_stages"])
        finally:
            svc.close()
            pt.close()
    _same_answer(got[PORT][0], got[REF][0])
    assert got[PORT][1:] == got[REF][1:]
    assert got[PORT][1] >= 1 and got[PORT][2] >= 1 and got[PORT][3] == []


# --------------------------------------------------------------------------- #
# the disk_insitu dispatch probe, measured where the port runs
# --------------------------------------------------------------------------- #

def test_disk_probe_env_override_and_measurement(monkeypatch):
    D = PORT.dispatch
    monkeypatch.setenv("PREDTRACE_DISK_CUTOVER", "12345")
    D.reset_for_tests()
    try:
        p = D.disk_scan_probe()
        assert p.value == 12345 and p.source == "env"
        monkeypatch.delenv("PREDTRACE_DISK_CUTOVER")
        D.reset_for_tests()
        p = D.disk_scan_probe()
        assert 256 <= p.value <= (1 << 20) and p.source == "measured"
        assert D.disk_scan_probe() is p
        assert D.probe_info()["disk"]["value"] == p.value
        D.note_disagreement("disk")
        assert D.probe_info()["disk"] is None
    finally:
        D.reset_for_tests()


@pytest.mark.parametrize("atoms,route", [(1, "disk_insitu"),
                                         (3, "device_insitu")])
def test_measured_seeds_route_a_demoted_stage(monkeypatch, atoms, route):
    """The card host's measured seeds (``cost.DISK_RATIO`` = 0.55 against
    ``DEVICE_RATIO_CUDA`` = 0.022) decide a demoted stage's first scan:
    with the device cutover at n rows x 1 atom and the disk cutover at 0,
    the memmap compare wins while the work stays under 0.978 / (0.55 -
    0.022) = 1.85 times the device cutover.  One atom (work = the cutover)
    stays on the host; three atoms go to the card.  The reference's copied
    seed, DISK_RATIO = 2.0, sent even one atom to the card."""
    from repro_torch.core import cost

    assert (cost.INSITU_RATIO, cost.MEMBER_RATIO, cost.RLE_RATIO,
            cost.DISK_RATIO) == (0.51, 0.42, 0.45, 0.55)
    n = 20_000
    monkeypatch.setenv("PREDTRACE_DEVICE_CUTOVER", str(n))
    monkeypatch.setenv("PREDTRACE_DISK_CUTOVER", "0")
    PORT.dispatch.reset_for_tests()
    t = scan_table(PORT, n)
    store = PORT.store.IntermediateStore()
    store.put(1, t)
    store.demote(1)
    E = PORT.expr
    pred = E.land(*[E.Col(c) >= 3 for c in ("a", "c", "b")[:atoms]]) \
        if atoms > 1 else E.Col("a") >= 3
    eng = PORT.ScanEngine()
    try:
        got = store.scan(1, pred, {}, eng)
        assert np.array_equal(got, eng.scan(pred, t, {}))
        chosen = {"disk_insitu": eng.stats.disk_insitu_chosen,
                  "device_insitu": eng.stats.device_chosen}
        assert chosen == {k: int(k == route) for k in chosen}
    finally:
        store.close()
        PORT.dispatch.reset_for_tests()


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
def test_cuda_demoted_stage_scan_launches_k1(cuda, forced_device):
    from repro_torch.kernels.pred_filter import LAUNCHES

    t = scan_table(PORT, 100_000)
    masks = {}
    for device in ("cpu", "cuda"):
        store = PORT.store.IntermediateStore(part_rows=8192)
        store.put(1, t)
        st = store.demote(1)
        eng = PORT.scan.ScanEngine("torch", device=device)
        before = LAUNCHES["cmp"]
        masks[device] = [
            eng.backend.scan_stored(eng.compile(p), st, {}, force=True)
            for p in (PORT.expr.Col("a") >= 10,
                      PORT.expr.land(PORT.expr.Col("a") < 40,
                                     PORT.expr.Col("c") >= 7))]
        if device == "cuda":
            assert LAUNCHES["cmp"] >= before + 2
        assert store.scan(1, PORT.expr.Col("c") < 50, {}, eng) is not None
        store.close()
    for a, b in zip(masks["cpu"], masks["cuda"]):
        assert a is not None and np.array_equal(a, b)
