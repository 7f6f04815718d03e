"""The port's ``TorchBackend`` scan engine against the JAX package's.

``ScanEngine(backend="torch", device="cpu", device_cutover=0)`` (the plain
PyTorch version of the kernel) is held against the reference's
``ScanEngine(backend="pallas", device_cutover=0)`` and its numpy oracle on
the same numpy inputs: identical masks, and identical device counters
(launches, pruned blocks, fused membership, float key lanes).  Each check
uses fresh engines, so both cost models decide from their seeds alone.
A parametrised subset of ``tests/test_device_scan.py``, including the
``scan_stored`` and run-space RLE legs.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

import repro.core.expr as rE
import repro.core.scan as rS
import repro.core.store as rST
import repro.core.table as rT
import repro_torch.core.expr as pE
import repro_torch.core.scan as pS
import repro_torch.core.store as pST
import repro_torch.core.table as pT

N = 4096
REF = types.SimpleNamespace(E=rE, S=rS, ST=rST, T=rT)
PORT = types.SimpleNamespace(E=pE, S=pS, ST=pST, T=pT)

STAT_KEYS = ("device_scans", "device_rows", "device_blocks_pruned",
             "device_batch_scans", "device_batch_rows", "member_fused_scans",
             "member_fused_sets", "float_lane_scans", "rle_run_scans",
             "rle_rows_expanded", "partitions_scanned", "partitions_pruned")


def _stats(eng):
    snap = eng.stats.snapshot()
    return {k: snap[k] for k in STAT_KEYS}


def _engines():
    return (rS.ScanEngine(),
            rS.ScanEngine(backend="pallas", device_cutover=0),
            pS.ScanEngine(backend="torch", device="cpu", device_cutover=0))


def _check(make_pred, make_table, binding, expect_device=True):
    """One scan per fresh engine: masks and device counters must agree."""
    ref_np, ref_dev, port = _engines()
    want = ref_np.scan(make_pred(rE), make_table(rT), binding)
    got_ref = ref_dev.scan(make_pred(rE), make_table(rT), binding)
    got = port.scan(make_pred(pE), make_table(pT), binding)
    assert np.array_equal(got_ref, want)
    assert got.dtype == np.bool_ and np.array_equal(got, want)
    assert _stats(port) == _stats(ref_dev)
    if expect_device:
        assert port.stats.device_scans > 0
    return got


def _table(**cols):
    return lambda T: T.Table(dict(cols), {}, "t")


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32, np.int64,
                                   np.uint8, np.uint16, np.bool_])
def test_integer_dtypes(dtype):
    rng = np.random.default_rng(7)
    hi = 2 if dtype == np.bool_ else min(np.iinfo(dtype).max, 500)
    a = rng.integers(0, hi, N).astype(dtype)
    k = rng.integers(0, 100, N).astype(np.int32)
    mk = _table(a=a, k=k)
    _check(lambda E: E.land(E.Col("a") >= E.Param("p"), E.Col("k") < E.Lit(80)),
           mk, {"p": int(hi) // 2})
    _check(lambda E: E.land(E.Col("a").eq(E.Param("p")), E.Col("k").ne(E.Lit(3))),
           mk, {"p": 1})


def test_float64_falls_back_identically():
    rng = np.random.default_rng(8)
    f = rng.normal(0, 100, N)
    f[::17] = np.nan
    k = rng.integers(0, 1000, N).astype(np.int32)
    m = _check(lambda E: E.land(E.Col("f") >= E.Param("p"), E.Col("k") < E.Param("q")),
               _table(f=f, k=k), {"p": -5.5, "q": 900})
    assert not m[::17].any()


@pytest.mark.parametrize("p", [np.nan, np.inf, -np.inf, 0.5, -0.5, 2.0 ** 33,
                               -(2.0 ** 33), 7])
def test_threshold_translation(p):
    rng = np.random.default_rng(9)
    mk = _table(k=rng.integers(-1000, 1000, N).astype(np.int64))
    for make in (lambda E: E.Col("k") > E.Param("p"),
                 lambda E: E.Col("k") <= E.Param("p"),
                 lambda E: E.Col("k").eq(E.Param("p")),
                 lambda E: E.Col("k").ne(E.Param("p"))):
        # non-integral / out-of-range thresholds stay on the host in both
        _check(make, mk, {"p": p}, expect_device=False)


_F32 = [0.0, -0.0, 3.0, np.nan, np.inf, -np.inf, 3.0000000001, 1e40,
        np.float64(3.0000000001), np.int64(2 ** 62), np.float32(0.25), True]


@pytest.mark.parametrize("v", _F32, ids=[f"{type(v).__name__}-{v}" for v in _F32])
def test_float32_key_lane(v):
    rng = np.random.default_rng(40)
    f = rng.normal(0, 100, N).astype(np.float32)
    f[::13] = np.nan
    f[1::97], f[2::97] = np.inf, -np.inf
    f[3::31], f[4::31] = -0.0, 0.0
    f[5::17] = np.float32(3.0)
    mk = _table(f=f, k=rng.integers(0, 100, N).astype(np.int32))
    for op in ("<", "<=", ">", ">=", "==", "!="):
        m = _check(lambda E: E.BinOp(op, E.Col("f"), E.Param("p")), mk, {"p": v})
        if op != "!=":
            assert not m[np.isnan(f)].any()


def test_membership_atoms():
    rng = np.random.default_rng(10)
    mk = _table(k=rng.integers(0, 500, N).astype(np.int32),
                j=rng.integers(0, 100, N).astype(np.int32))
    vset = np.unique(rng.integers(0, 500, 40)).astype(np.int32)
    _check(lambda E: E.land(E.IsIn(E.Col("k"), vset.tolist()),
                            E.Col("j") >= E.Param("p")), mk, {"p": 20})
    _check(lambda E: E.land(E.IsIn(E.Col("k"), E.Param("s")),
                            E.Col("j") < E.Lit(90)), mk, {"s": vset})
    # pure membership: the tautology atom rides the set column
    m = _check(lambda E: E.IsIn(E.Col("k"), E.Param("s")), mk, {"s": vset})
    assert m.any()


@pytest.mark.parametrize("s", [np.array([], np.int32), np.array([10 ** 6]),
                               np.array([-1, 10 ** 9]), np.array([3.0, 3.5, 7.0])],
                         ids=["empty", "disjoint", "straddles", "float-set"])
def test_membership_empty_and_disjoint_sets(s):
    rng = np.random.default_rng(43)
    k = rng.integers(0, 500, N).astype(np.int32)
    m = _check(lambda E: E.IsIn(E.Col("k"), E.Param("s")), _table(k=k), {"s": s})
    assert np.array_equal(m, np.isin(k, s))


def test_disjunction_residual():
    rng = np.random.default_rng(11)
    mk = _table(a=rng.integers(0, 100, N).astype(np.int32),
                b=rng.integers(0, 100, N).astype(np.int32))
    _check(lambda E: E.lor(E.Col("a") < E.Param("p"), E.Col("b") >= E.Lit(95)),
           mk, {"p": 5}, expect_device=False)


@pytest.mark.parametrize("n", [1, 1000, 1024, 1025, 4097])
def test_ragged_row_counts(n):
    rng = np.random.default_rng(n)
    m = _check(lambda E: E.Col("a") >= E.Param("p"),
               _table(a=rng.integers(-50, 50, n).astype(np.int32)), {"p": 0})
    assert m.shape == (n,)


def test_empty_table():
    m = _check(lambda E: E.Col("a") >= E.Param("p"),
               _table(a=np.zeros(0, np.int32)), {"p": 0}, expect_device=False)
    assert m.shape == (0,)


def test_sorted_column_prunes_blocks():
    a = np.sort(np.random.default_rng(12).integers(0, 100_000, 16 * 1024))
    _check(lambda E: E.land(E.Col("a") >= E.Param("p"), E.Col("a") < E.Param("q")),
           _table(a=a.astype(np.int32)), {"p": 40_000, "q": 45_000})


@pytest.mark.parametrize("k_bindings", [1, 3, 8])
def test_batched_bindings(k_bindings):
    rng = np.random.default_rng(12)
    a = rng.integers(0, 10_000, N).astype(np.int32)
    b = rng.integers(0, 100, N).astype(np.int32)
    base = [{"p": int(v), "q": 50 + i}
            for i, v in enumerate(rng.integers(0, 12_000, k_bindings))]
    if k_bindings >= 3:
        base[1] = dict(base[0])
        base[-1] = {"p": 10 ** 7, "q": 0}
    ref_np, ref_dev, port = _engines()
    mk = _table(a=a, b=b)

    def pred(E):
        return E.land(E.Col("a") >= E.Param("p"), E.Col("b") < E.Param("q"))

    want = [np.flatnonzero(ref_np.scan(pred(rE), mk(rT), bd)) for bd in base]
    got_ref = ref_dev.scan_batch_idx(pred(rE), mk(rT), base)
    got = port.scan_batch_idx(pred(pE), mk(pT), base)
    for w, r, g in zip(want, got_ref, got):
        assert np.array_equal(w, r) and np.array_equal(w, g)
    assert _stats(port) == _stats(ref_dev)
    assert port.stats.device_batch_scans == 1


def test_batch_heterogeneous_set_sizes():
    rng = np.random.default_rng(45)
    mk = _table(k=rng.integers(0, 500, N).astype(np.int32),
                j=rng.integers(0, 100, N).astype(np.int32))
    base = [
        {"s": np.array([7], np.int32), "q": 90},
        {"s": np.unique(rng.integers(0, 500, 40)).astype(np.int64), "q": 50},
        {"s": np.array([], np.int32), "q": 99},
        {"s": np.unique(rng.integers(0, 500, 200)).astype(np.int32), "q": 10},
    ]

    def pred(E):
        return E.land(E.IsIn(E.Col("k"), E.Param("s")), E.Col("j") < E.Param("q"))

    _, ref_dev, port = _engines()
    ref_masks = ref_dev.backend.scan_batch_fused(ref_dev.compile(pred(rE)),
                                                 mk(rT), base)
    masks = port.backend.scan_batch_fused(port.compile(pred(pE)), mk(pT), base)
    assert masks is not None and ref_masks is not None
    for r, m in zip(ref_masks, masks):
        assert np.array_equal(r, m)
    assert not masks[2].any()
    assert _stats(port) == _stats(ref_dev)


def test_batch_float_lane_bindings():
    rng = np.random.default_rng(46)
    f = rng.normal(0, 10, N).astype(np.float32)
    f[::11] = np.nan
    mk = _table(f=f, j=rng.integers(0, 100, N).astype(np.int32))
    base = [{"p": -5.5, "q": 90}, {"p": np.nan, "q": 99},
            {"p": 1e40, "q": 50}, {"p": np.float64(0.1), "q": 75}]

    def pred(E):
        return E.land(E.Col("f") >= E.Param("p"), E.Col("j") < E.Param("q"))

    ref_np, ref_dev, port = _engines()
    masks = port.backend.scan_batch_fused(port.compile(pred(pE)), mk(pT), base)
    ref_masks = ref_dev.backend.scan_batch_fused(ref_dev.compile(pred(rE)),
                                                 mk(rT), base)
    for bd, m, r in zip(base, masks, ref_masks):
        assert np.array_equal(m, r)
        assert np.array_equal(m, ref_np.scan(pred(rE), mk(rT), bd))
    assert _stats(port) == _stats(ref_dev)


def test_partitioned_table_prunes_identically():
    rng = np.random.default_rng(30)
    n = 1 << 14
    a = np.sort(rng.integers(0, 10_000, n)).astype(np.int32)
    b = rng.integers(0, 100, n).astype(np.int32)
    # thresholds off the pruned-vs-full cost tie (13 of 16 partitions
    # alive), where each engine's measured host cost would break it
    for p in (0, 3_000, 9_990, 10 ** 6):
        _check(lambda E: E.land(E.Col("a") >= E.Param("p"), E.Col("b") < E.Lit(90)),
               lambda T: T.partition_table(T.Table({"a": a, "b": b}, {}, "t"), 16),
               {"p": p}, expect_device=p < 10 ** 6)


# --------------------------------------------------------------------------- #
# encoded stages: scan_stored (code-space slabs) and the run-space RLE lane
# --------------------------------------------------------------------------- #
def _check_stored(make_enc, make_pred, binding):
    ref_np, ref_dev, port = _engines()
    enc_r, enc_p = make_enc(rST), make_enc(pST)
    st_r = rST.StoredTable({"c": enc_r}, {}, "st", enc_r.n, enc_r.n * 8)
    st_p = pST.StoredTable({"c": enc_p}, {}, "st", enc_p.n, enc_p.n * 8)
    want = ref_np.scan(make_pred(rE), st_r.to_table(), binding)
    got_ref = ref_dev.backend.scan_stored(ref_dev.compile(make_pred(rE)), st_r,
                                          binding)
    got = port.backend.scan_stored(port.compile(make_pred(pE)), st_p, binding)
    assert (got is None) == (got_ref is None)
    if got is not None:
        assert np.array_equal(got, want) and np.array_equal(got, got_ref)
    assert _stats(port) == _stats(ref_dev)


_OPS6 = ("==", "!=", "<", "<=", ">", ">=")


def _each_op(make_enc, values):
    for v in values:
        for op in _OPS6:
            _check_stored(make_enc, lambda E: E.BinOp(op, E.Col("c"), E.Param("p")),
                          {"p": v})


def test_stored_dict():
    arr = np.random.default_rng(20).choice(
        np.array([-7, 3, 50, 1_000_000], np.int64), N)
    _each_op(lambda ST: ST.DictColumn.encode(arr),
             (-7, 3, 50, 1_000_000, 4, -100, 2_000_000, 49))


def test_stored_dict_nan_values_gate():
    arr = np.array([0.5, 1.5, np.nan, 1.5, np.nan, 0.5] * 300)
    _each_op(lambda ST: ST.DictColumn.encode(arr), (1.0, 1.5, 0.5))


def test_stored_for_and_bitpack():
    rng = np.random.default_rng(21)
    arr = (rng.integers(0, 1000, N) + 10_000_000_000).astype(np.int64)
    lo, hi = int(arr.min()), int(arr.max())
    _each_op(lambda ST: ST.FORColumn.encode(arr, np.uint16),
             (lo, hi, (lo + hi) // 2, lo - 5, hi + 5, 0, 10_000_000_000.5))
    bits = rng.integers(0, 2, N).astype(bool)
    _each_op(lambda ST: ST.BitPackColumn.encode(bits), (0, 1))


def test_stored_rle_delta_scaled():
    rle = np.repeat(np.array([3, 9, 3, 15, 15, -2], np.int64), [4, 1, 3, 2, 6, 5])
    _each_op(lambda ST: ST.RLEColumn.encode(rle),
             (-3, -2, 2, 3, 4, 9, 15, 16, 2.5, np.nan))
    rng = np.random.default_rng(50)
    srt = np.sort(rng.integers(0, 10 ** 7, N)).astype(np.int64)
    _each_op(lambda ST: ST.encode_column(srt),
             (int(srt[0]), int(srt[-1]), int(srt[N // 2]), -1, 2 * 10 ** 7, 0.5))
    dec = (rng.integers(-10_000, 10_000, N) / 100).astype(np.float32)
    _each_op(lambda ST: ST.encode_column(dec),
             (0.01, -0.01, 0.005, 99.99, np.float64(0.1), np.float32(0.25),
              0, np.nan, np.inf))


def test_stored_unbound_param_refused():
    arr = np.arange(N, dtype=np.int64) % 16
    _, ref_dev, port = _engines()
    for ns, eng in ((REF, ref_dev), (PORT, port)):
        enc = ns.ST.DictColumn.encode(arr)
        st = ns.ST.StoredTable({"c": enc}, {}, "st", enc.n, enc.n * 8)
        prog = eng.compile(ns.E.Col("c") >= ns.E.Param("p"))
        assert eng.backend.scan_stored(prog, st, {}) is None
        with pytest.raises(KeyError):  # the host fallback raises uniformly
            eng.scan(ns.E.Col("c") >= ns.E.Param("p"), st.to_table(), {})


def test_store_dispatch_insitu_rle():
    rng = np.random.default_rng(52)
    runs = rng.integers(50, 400, 2000)
    vals = rng.integers(0, 40, runs.size)
    a = np.repeat(vals, runs)[:200_000].astype(np.int64)
    _, ref_dev, port = _engines()
    got = {}
    for name, ns, eng in (("ref", REF, ref_dev), ("port", PORT, port)):
        store = ns.ST.IntermediateStore()
        st = store.put(7, ns.T.Table({"a": a}, {}, "t"))
        assert st.enc["a"].kind == "rle"
        got[name] = store.scan(7, ns.E.Col("a") < ns.E.Param("v"), {"v": 20}, eng)
        assert eng.stats.rle_insitu_chosen == 1 and eng.stats.decode_chosen == 0
    assert np.array_equal(got["port"], got["ref"])
    assert np.array_equal(got["port"], a < 20)
    assert _stats(port) == _stats(ref_dev)


# --------------------------------------------------------------------------- #
# eval_torch (the port's eval_jnp) and the explicit device
# --------------------------------------------------------------------------- #
def test_eval_torch_matches_eval_np_and_eval_jnp():
    rng = np.random.default_rng(60)
    env_np = {"a": rng.integers(0, 50, 256).astype(np.int32),
              "d": rng.integers(19920101, 19981231, 256).astype(np.int32),
              "x": rng.normal(size=256).astype(np.float32)}
    env_t = {k: torch.from_numpy(v) for k, v in env_np.items()}
    vset = np.array([1, 5, 9, 44])

    def exprs(E):
        return [
            E.land(E.Col("a") >= E.Param("p"), E.Col("a") < E.Lit(40)),
            E.lor(E.Col("a").eq(E.Param("s")), E.Col("x") > E.Lit(0.5)),
            E.IsIn(E.Col("a"), (2, 3, 4)),
            E.UnaryOp("year", E.Col("d")).eq(E.Lit(1995)),
            E.IfThenElse(E.Col("x") > E.Lit(0.0), E.Col("a"),
                         E.UnaryOp("neg", E.Col("a"))) > E.Lit(3),
            E.lnot(E.Col("a") * E.Lit(2) + E.Lit(1) <= E.Param("p")),
        ]

    binding = {"p": 17, "s": vset}
    import jax.numpy as jnp

    env_j = {k: jnp.asarray(v) for k, v in env_np.items()}
    for ep, er in zip(exprs(pE), exprs(rE)):
        want = np.broadcast_to(np.asarray(rE.eval_np(er, env_np, binding, n=256)),
                               (256,))
        ref = np.asarray(rE.eval_jnp(er, env_j, binding))
        got = pE.eval_torch(ep, env_t, binding, device="cpu")
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(got.numpy(), ref)


def test_backend_device_is_explicit(monkeypatch):
    import repro_torch.core.executor as pX

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pS, "_DEFAULT_ENGINE", None)
    with pytest.raises(RuntimeError):
        pS.ScanEngine(backend="torch")
    with pytest.raises(RuntimeError):
        pS.ScanEngine()
    with pytest.raises(RuntimeError):
        pS.TorchBackend(device="cuda")
    with pytest.raises(RuntimeError):
        pX.Executor({})
    with pytest.raises(RuntimeError):
        pS.default_engine()
    assert pS.TorchBackend(device="cpu").device == torch.device("cpu")
    eng = pX.Executor({}, device="cpu").scan_engine
    assert isinstance(eng.backend, pS.TorchBackend)
    assert eng.backend.device == torch.device("cpu")
    assert isinstance(pS.ScanEngine("numpy").backend, pS.NumpyBackend)
    with pytest.raises(ValueError):
        pS.ScanEngine(backend="pallas")


@pytest.mark.parametrize("kind", ["compares", "sets", "batch"])
def test_wide_program_runs_in_one_launch(kind):
    """A program with more atoms than a kernel parameter block would hold
    (80 compares, 20 IN atoms) still rides one launch, like the reference."""
    rng = np.random.default_rng(70)
    cols = {f"c{i}": rng.integers(0, 1000, 1024).astype(np.int32)
            for i in range(4)}
    sets = [np.unique(rng.integers(0, 1000, 4000)).astype(np.int32)
            for _ in range(20)]
    n_cmp = 80 if kind != "sets" else 2

    def pred(E):
        atoms = [E.Col(f"c{i % 4}") >= E.Param(f"p{i}") for i in range(n_cmp)]
        if kind != "compares":
            atoms += [E.IsIn(E.Col(f"c{i % 4}"), sets[i].tolist())
                      for i in range(20)]
        return E.land(*atoms)

    binding = {f"p{i}": int(i) for i in range(n_cmp)}
    if kind != "batch":
        m = _check(pred, _table(**cols), binding)
        assert m.any()
        _, _, port = _engines()
        port.scan(pred(pE), _table(**cols)(pT), binding)
        assert port.stats.device_scans == 1
        return
    base = [binding, {f"p{i}": int(2 * i) for i in range(n_cmp)}]
    ref_np, ref_dev, port = _engines()
    want = [np.flatnonzero(ref_np.scan(pred(rE), _table(**cols)(rT), b))
            for b in base]
    got_ref = ref_dev.scan_batch_idx(pred(rE), _table(**cols)(rT), base)
    got = port.scan_batch_idx(pred(pE), _table(**cols)(pT), base)
    for w, r, g in zip(want, got_ref, got):
        assert np.array_equal(w, r) and np.array_equal(w, g)
    assert _stats(port) == _stats(ref_dev)
    assert port.stats.device_batch_scans == 1
