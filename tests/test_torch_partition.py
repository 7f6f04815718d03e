"""The port's partition runtime against the JAX package's.

The lineage tests of ``tests/test_partition.py`` and the lineage case of
``tests/test_distributed.py``, through both packages on the same seeded
TPC-H catalog (sf 0.002): partitioned, pooled (``parallel=``) and sharded
(``mesh=``) answers must equal the reference's unpartitioned ones, lineage
row sets and ``precise`` flags alike.  The port runs on ``device="cpu"``
with its device cutovers forced to 0, so every in-fragment scan goes
through the kernel's plain PyTorch version.  A mesh here is
``("cpu",) * 4``: four shards of every table, each scanned by the torch
backend, where the reference test uses eight virtual JAX host devices.

Beyond the reference's cases: a shard split that is not aligned to a
kernel zone block, the two inputs that the reference's JAX mesh gets wrong
(pinned against the numpy backend), a launch error on a shard reaching the
caller, and shard slices that stay stable across refinement iterations.
"""

from __future__ import annotations

import tempfile

import numpy as np
import pytest
import torch

from test_torch_incremental import BOTH, PORT, REF
from test_torch_lineage_tpch import CUTOVER_ENV, _as_numpy, _same_answer

from repro.core import distributed as ref_distributed
from repro_torch.core import distributed as port_distributed

DIST = {REF: ref_distributed, PORT: port_distributed}


@pytest.fixture(autouse=True)
def forced_device(monkeypatch):
    for k in CUTOVER_ENV:
        monkeypatch.setenv(k, "0")


@pytest.fixture(autouse=True)
def spill_under_tmp(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


@pytest.fixture(scope="module")
def dbs():
    from repro.tpch import generate

    ref = generate(sf=0.002, seed=1)
    return {REF: ref,
            PORT: PORT.table.catalog_from_numpy(_as_numpy(ref), device="cpu")}


def prepared(pkg, db, qname, **kw):
    plan = pkg.queries[qname](db)
    res = pkg.Executor(db).run(plan)
    pt = pkg.PredTrace(db, plan, **kw)
    pt.infer(stats=res.stats)
    pt.run()
    return pt


def iterative(pkg, db, qname, **kw):
    pt = pkg.PredTrace(db, pkg.queries[qname](db), **kw)
    pt.infer_iterative()
    pt.run_unmodified()
    return pt


def answers(pt, n):
    """query, query_batch and query_iterative of the first ``n`` rows."""
    out = [pt.query(r) for r in range(n)]
    out += pt.query_batch(list(range(n)))
    pt.infer_iterative()
    out += [pt.query_iterative(r) for r in range(min(2, n))]
    return out


def same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _same_answer(a, b)


# --------------------------------------------------------------------------- #
# partitioned == plain, port == reference
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("qname", ["q3", "q5", "q10"])
def test_tpch_partitioned_matches_plain(dbs, qname):
    ref = prepared(REF, dbs[REF], qname)
    n = min(6, ref.exec_result.output.nrows)
    assert n > 0
    want = answers(ref, n)
    pt = prepared(PORT, dbs[PORT], qname, num_partitions=16)
    same(answers(pt, n), want)
    same(answers(prepared(REF, dbs[REF], qname, num_partitions=16), n), want)
    st = pt.scan_engine.stats
    assert st.prune_calls > 0 and st.partitions_pruned > 0


@pytest.mark.parametrize("qname", ["q3", "q10"])
def test_tpch_partitioned_store_matches(dbs, qname):
    """Partitioned *encoded* stages: in-situ pruned scans stay identical to
    the reference and to a decoded scan."""
    ref = prepared(REF, dbs[REF], qname)
    n = min(6, ref.exec_result.output.nrows)
    pt = prepared(PORT, dbs[PORT], qname, store=True, num_partitions=8)
    assert any(st.zone_maps is not None for st in pt.store.stages.values())
    same([pt.query(r) for r in range(n)], [ref.query(r) for r in range(n)])
    binding = pt._output_binding(0)
    checked = 0
    for st in pt.lineage_plan.stages:
        if PORT.expr.params_of(st.run_pred) - set(binding):
            continue
        got = pt.store.scan(st.node_id, st.run_pred, binding, pt.scan_engine)
        want = pt.scan_engine.backend.scan(
            pt.scan_engine.compile(st.run_pred), pt.store.table(st.node_id),
            binding)
        assert np.array_equal(got, want), (qname, st.node_id)
        checked += 1
    assert checked > 0


@pytest.mark.parametrize("budget_frac", [None, 0.5, 0.0])
def test_partitioned_budgets_match_plain(dbs, budget_frac):
    kw = {}
    if budget_frac is not None:
        full = prepared(REF, dbs[REF], "q3", store=True)
        kw = {"budget_bytes": int(full.store.nbytes() * budget_frac)}
    ref = prepared(REF, dbs[REF], "q3", **kw)
    n = min(4, ref.exec_result.output.nrows)
    want = [ref.query(r) for r in range(n)] + ref.query_batch(list(range(n)))
    for parts in (None, 16):
        pt = prepared(PORT, dbs[PORT], "q3", num_partitions=parts, **kw)
        same([pt.query(r) for r in range(n)] + pt.query_batch(list(range(n))),
             want)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_parallel_partition_scans_deterministic(dbs, backend):
    """A worker pool over partitions: the numpy backend fans surviving
    partitions out to the pool; the torch backend carries each scan as one
    launch on the calling thread.  Repeated runs give the reference's
    answers."""
    ref = prepared(REF, dbs[REF], "q3")
    n = min(4, ref.exec_result.output.nrows)
    want = [ref.query(r) for r in range(n)]
    engine = (PORT.scan.ScanEngine("numpy") if backend == "numpy"
              else PORT.ScanEngine())
    pt = prepared(PORT, dbs[PORT], "q3", num_partitions=16, parallel=4,
                  scan_engine=engine)
    assert pt.partition_exec is not None
    pt.partition_exec.min_parallel_rows = 0
    try:
        for _ in range(3):  # repeated runs: merge order is deterministic
            same([pt.query(r) for r in range(n)], want)
    finally:
        pt.close()
    st = pt.scan_engine.stats
    if backend == "numpy":
        assert pt.scan_engine.fanout is pt.partition_exec
        assert st.fanout_scans > 0
    else:
        assert pt._scan == pt.partition_exec.scan
        assert st.device_scans > 0 and st.fanout_scans == 0
    assert pt.partition_exec._pool is None  # closed


def test_parallel_one_worker_is_not_the_default_pool(dbs):
    pt = PORT.PredTrace(dbs[PORT], PORT.queries["q3"](dbs[PORT]),
                        num_partitions=4, parallel=1)
    assert pt.partition_exec.max_workers == 1
    assert pt.partition_exec.pool() is None
    pt.close()


def table(pkg, n=4000, seed=7):
    rng = np.random.default_rng(seed)
    return pkg.table.Table.from_dict({
        "k": np.sort(rng.integers(0, 10 * n, n)),
        "g": rng.integers(0, 40, n),
        "f": np.where(rng.random(n) < 0.1, np.nan, rng.normal(100.0, 20.0, n)),
        "b": rng.random(n) < 0.5,
        "s": rng.choice(["aa", "bb", "cc", "dd"], n),
        "neg": rng.integers(-5, 5, n),
    })


def predicates(pkg, t):
    """(predicate, binding) pairs of ``tests/test_partition.py``'s sweep."""
    E = pkg.expr
    Col, Param = E.Col, E.Param
    k = np.asarray(t.cols["k"])
    return [
        (Col("k").eq(Param("v")), {"v": int(k[123])}),
        (Col("k").eq(Param("v")), {"v": -99}),
        (Col("g") < Param("v"), {"v": 100}),
        (E.land(Col("k") >= Param("a"), Col("k") <= Param("b")),
         {"a": int(k[50]), "b": int(k[90])}),
        (E.land(Col("g").eq(Param("v")), Col("f") > Param("w")),
         {"v": 3, "w": 110.0}),
        (Col("f").eq(Param("v")), {"v": float("nan")}),
        (Col("neg").ne(Param("v")), {"v": -1}),
        (Col("s").eq(Param("v")), {"v": 2}),
        (Col("k").isin(Param("vs")), {"vs": np.unique(k[:7])}),
        (Col("k").eq(Param("vs")), {"vs": k[200:204]}),
        (E.land(Col("b").eq(Param("v")), Col("g") >= 20), {"v": True}),
        (E.lor(Col("g") < 2, Col("g") > 37), {}),
    ]


def test_partition_executor_plain_table_passthrough():
    masks = {}
    for pkg in BOTH:
        t = table(pkg, 1000)
        pred = pkg.expr.Col("g") < pkg.expr.Param("v")
        pexec = DIST[pkg].PartitionExecutor(pkg.ScanEngine(), max_workers=2)
        try:
            masks[pkg] = pexec.scan(pred, t, {"v": 20})
        finally:
            pexec.close()
        assert np.array_equal(masks[pkg], pkg.ScanEngine().scan(pred, t, {"v": 20}))
    assert np.array_equal(masks[PORT], masks[REF])


@pytest.mark.parametrize("mesh", [None, ("cpu",) * 4])
def test_distributed_refine_routes_through_engine(dbs, mesh):
    """distributed_refine is the shared refine loop over the shared engine,
    with optional partitioning (and, in the port, a mesh of torch devices):
    answers match the reference's query_iterative."""
    ref = iterative(REF, dbs[REF], "q3")
    want = ref.query_iterative(0)
    pt = iterative(PORT, dbs[PORT], "q3")
    eng = PORT.ScanEngine()
    ans = port_distributed.distributed_refine(
        pt.iter_plan, dbs[PORT], pt._output_binding(0), mesh=mesh,
        engine=eng, num_partitions=8)
    assert sorted(ans.lineage) == sorted(want.lineage)
    for t in want.lineage:
        assert np.array_equal(np.sort(ans.lineage[t]), np.sort(want.lineage[t]))
    assert ans.detail["iterations"] >= 1
    assert eng.stats.scans > 0 and eng.stats.device_scans > 0


# --------------------------------------------------------------------------- #
# the mesh: test_distributed.py's lineage case, shards, the reference faults
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("qname", ["q3", "q4", "q12"])
def test_distributed_lineage_matches_local(dbs, qname):
    """``distributed_refine`` over a four-shard mesh equals the reference's
    local ``query_iterative``; so do a ``PredTrace(mesh=...)``'s query,
    query_batch and query_iterative."""
    ref = iterative(REF, dbs[REF], qname)
    assert ref.exec_result.output.nrows > 0
    local = ref.query_iterative(0)
    pt = iterative(PORT, dbs[PORT], qname)
    dist = port_distributed.distributed_refine(
        pt.iter_plan, dbs[PORT], pt._output_binding(0), mesh=("cpu",) * 4,
        engine=PORT.ScanEngine())
    for tab in set(local.lineage) | set(dist.lineage):
        a = set(local.lineage.get(tab, np.array([])).tolist())
        b = set(dist.lineage.get(tab, np.array([])).tolist())
        assert a == b, (qname, tab, len(a), len(b))
    want_pt = prepared(REF, dbs[REF], qname)
    n = min(3, want_pt.exec_result.output.nrows)
    meshed = prepared(PORT, dbs[PORT], qname, mesh=("cpu",) * 4)
    assert meshed._scan == meshed.partition_exec.scan
    same(answers(meshed, n), answers(want_pt, n))


def test_shard_bounds_cover_rows_in_order():
    sb = port_distributed.shard_bounds
    assert sb(5_998_178, 2) == [(0, 2_999_089), (2_999_089, 5_998_178)]
    assert sb(2, 4) == [(0, 0), (0, 1), (1, 1), (1, 2)]
    for n, s in ((0, 3), (10, 3), (4097, 4)):
        b = sb(n, s)
        assert b[0][0] == 0 and b[-1][1] == n and len(b) == s
        assert all(b[i][1] == b[i + 1][0] for i in range(s - 1))


@pytest.mark.parametrize("shards,parts", [(2, None), (3, None), (3, 7)])
def test_mesh_shards_not_aligned_to_a_block(shards, parts):
    """Shards that start inside a 1,024-row zone block (5,000 rows over two
    or three shards) build their own slabs and zone bounds; every mask of
    the partition sweep equals the numpy backend's on the whole table."""
    t = table(PORT, 5000)
    if parts is not None:
        t = PORT.table.partition_table(t, num_partitions=parts)
    starts = [lo for lo, _ in port_distributed.shard_bounds(5000, shards)]
    assert any(s % 1024 for s in starts)
    eng = PORT.ScanEngine()
    pexec = port_distributed.PartitionExecutor(eng, mesh=("cpu",) * shards)
    host = PORT.scan.ScanEngine("numpy")
    for pred, binding in predicates(PORT, t):
        assert np.array_equal(pexec.scan(pred, t, binding),
                              host.scan(pred, t, binding)), pred
    assert eng.stats.device_scans > 0


def test_mesh_reference_fault_inputs():
    """The reference's JAX mesh pads V-sets with a sentinel that becomes 0
    and truncates int64 to int32 (ROADMAP §3).  The port's mesh gives the
    numpy backend's masks on both inputs."""
    E = PORT.expr
    pexec = port_distributed.PartitionExecutor(PORT.ScanEngine(),
                                               mesh=("cpu",))
    host = PORT.scan.ScanEngine("numpy")
    cases = [
        (PORT.table.Table.from_dict({"a": np.array([0, 5, 7, 9])}),
         E.IsIn(E.Col("a"), E.ParamSet("v")), {"v": np.array([5, 7, 11])},
         [False, True, True, False]),
        (PORT.table.Table.from_dict({"a": np.array([5, 2**33 + 5, 7])}),
         E.Col("a").eq(5), {}, [True, False, False]),
    ]
    for t, pred, binding, want in cases:
        got = pexec.scan(pred, t, binding)
        assert got.tolist() == want
        assert np.array_equal(got, host.scan(pred, t, binding))


def test_shard_launch_error_reaches_distributed_refine(dbs, monkeypatch):
    """No host fallback: a kernel launch that fails on a shard fails the
    ``distributed_refine`` call with that error, even where the engine's
    own backend (numpy here) could have answered on the host."""
    pt = iterative(PORT, dbs[PORT], "q3")
    calls = []

    def broken(*a, **kw):
        calls.append(1)
        raise RuntimeError("pred_filter_batch kernel launch failed: cudaError 700")

    monkeypatch.setattr(PORT.scan, "pred_filter_batch", broken)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        port_distributed.distributed_refine(
            pt.iter_plan, dbs[PORT], pt._output_binding(0),
            mesh=("cpu", "cpu"), engine=PORT.scan.ScanEngine("numpy"))
    assert calls


def test_shard_slabs_stay_stable_across_iterations(monkeypatch):
    """Shard slices live with their table, so a repeated scan (a later
    refinement iteration) rebinds the predicate without rebuilding or
    re-uploading any shard slab."""
    builds = []
    real = PORT.scan.TorchBackend._build_entry

    def counted(self, slab):
        builds.append(slab.shape)
        return real(self, slab)

    monkeypatch.setattr(PORT.scan.TorchBackend, "_build_entry", counted)
    t = table(PORT, 5000)
    E = PORT.expr
    pexec = port_distributed.PartitionExecutor(PORT.ScanEngine(),
                                               mesh=("cpu", "cpu"))
    pred = E.land(E.Col("g") < E.Param("v"), E.Col("k").isin(E.Param("vs")))
    k = np.asarray(t.cols["k"])
    pexec.scan(pred, t, {"v": 30, "vs": np.unique(k[:50])})
    first = len(builds)
    assert first == 2  # one slab per shard
    for i in range(5):
        got = pexec.scan(pred, t, {"v": 10 + i, "vs": np.unique(k[i::7])})
        want = PORT.scan.ScanEngine("numpy").scan(
            pred, t, {"v": 10 + i, "vs": np.unique(k[i::7])})
        assert np.array_equal(got, want)
    assert len(builds) == first


def test_every_shard_scan_launches():
    """A mesh is an explicit placement: each in-fragment scan launches on
    every shard, however often it repeats (no cost model learns from the
    plain version's slower CPU times and moves shard scans to the host)."""
    t = table(PORT, 5000)
    E = PORT.expr
    eng = PORT.ScanEngine()
    pexec = port_distributed.PartitionExecutor(eng, mesh=("cpu", "cpu"))
    pred = E.Col("g") < E.Param("v")
    host = PORT.scan.ScanEngine("numpy")
    for v in range(12):
        before = eng.stats.device_scans
        assert np.array_equal(pexec.scan(pred, t, {"v": v}),
                              host.scan(pred, t, {"v": v}))
        assert eng.stats.device_scans == before + 2, v


def test_mesh_names_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        port_distributed.PartitionExecutor(PORT.ScanEngine(), mesh=("cuda:0",))
    with pytest.raises(ValueError):
        port_distributed.PartitionExecutor(PORT.ScanEngine(), mesh=())


# --------------------------------------------------------------------------- #
# partition-wise spill
# --------------------------------------------------------------------------- #

def test_partitioned_spill_roundtrip(tmp_path, dbs):
    ref = prepared(REF, dbs[REF], "q3", store=True, num_partitions=8)
    pt = prepared(PORT, dbs[PORT], "q3", store=True, num_partitions=8)
    want = ref.query(0)
    PORT.store_io.save_store(tmp_path, pt.store)
    reloaded = PORT.store_io.load_store(tmp_path)
    assert set(reloaded.stages) == set(pt.store.stages)
    assert reloaded.nbytes() == pt.store.nbytes() == ref.store.nbytes()
    for nid, st in pt.store.stages.items():
        if st.zone_maps is not None:
            zm = reloaded.stages[nid].zone_maps
            assert zm is not None
            assert zm.n_partitions == st.zone_maps.n_partitions
    pt.attach_store(reloaded)
    _same_answer(pt.query(0), want)


def test_scan_spilled_stage_loads_only_survivors(tmp_path, dbs):
    pt = prepared(PORT, dbs[PORT], "q3", store=True, num_partitions=8)
    ref = prepared(REF, dbs[REF], "q3", store=True, num_partitions=8)
    PORT.store_io.save_store(tmp_path / "port", pt.store)
    binding = pt._output_binding(0)
    ref_binding = ref._output_binding(0)
    eng = PORT.ScanEngine()
    checked = 0
    for st, ref_st in zip(pt.lineage_plan.stages, ref.lineage_plan.stages):
        if PORT.expr.params_of(st.run_pred) - set(binding):
            continue
        if pt.store.stages[st.node_id].zone_maps is None:
            continue
        want = ref.store.scan(ref_st.node_id, ref_st.run_pred, ref_binding,
                              ref.scan_engine)
        got = PORT.store_io.scan_spilled_stage(tmp_path / "port", st.node_id,
                                               st.run_pred, binding, eng)
        assert np.array_equal(got, want), st.node_id
        checked += 1
        zmaps = pt.store.stages[st.node_id].zone_maps
        alive = np.zeros(zmaps.n_partitions, dtype=bool)
        alive[0] = True
        sub, idx = PORT.store_io.load_stage_partitions(tmp_path / "port",
                                                       st.node_id, alive)
        assert sub.nrows == len(idx) == zmaps.part_bounds(0)[1]
    assert checked > 0


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
def test_cuda_mesh_shards_launch_k1_k2(cuda):
    """Two shards on one card: every mask of the sweep equals the numpy
    backend's, and the shards launched both kernel variants."""
    from repro_torch.kernels.pred_filter import LAUNCHES

    t = table(PORT, 300_000)
    pexec = port_distributed.PartitionExecutor(
        PORT.scan.ScanEngine("torch", device="cuda"), mesh=("cuda:0", "cuda:0"))
    host = PORT.scan.ScanEngine("numpy")
    before = dict(LAUNCHES)
    for pred, binding in predicates(PORT, t):
        assert np.array_equal(pexec.scan(pred, t, binding),
                              host.scan(pred, t, binding)), pred
    assert LAUNCHES["cmp"] > before["cmp"] and LAUNCHES["sets"] > before["sets"]


@pytest.mark.cuda
def test_cuda_parallel_and_mesh_lineage_match_numpy(cuda):
    from repro_torch.tpch import generate

    db = generate(sf=0.01, seed=1)
    for qname in ("q3", "q12"):
        want = prepared(PORT, db, qname, scan_engine=PORT.scan.ScanEngine("numpy"))
        n = min(4, want.exec_result.output.nrows)
        expect = answers(want, n)
        for kw in ({"num_partitions": 16, "parallel": 4},
                   {"mesh": ("cuda:0",)}, {"mesh": ("cuda:0", "cuda:0"),
                                            "num_partitions": 8}):
            pt = prepared(PORT, db, qname, device="cuda", **kw)
            same(answers(pt, n), expect)
            pt.close()
