"""The port's main path against the JAX package's on all 22 TPC-H queries.

At sf 0.002, seed 1: the port's dbgen equals the reference's column by
column; the reference's tables, handed over as numpy arrays through
``catalog_from_numpy``, feed the port's ``PredTrace(device="cpu")`` with the
device cutovers forced to 0, so every in-fragment scan goes through the
kernel's plain PyTorch version.  Pushed-down predicates, lineage row sets
and ``precise`` flags must be identical to the reference ``PredTrace``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import PredTrace as RefPredTrace
from repro.tpch import ALL_QUERIES as REF_QUERIES
from repro.tpch import generate as ref_generate
from repro.core import expr as ref_expr
from repro_torch.core import PredTrace, catalog_from_numpy
from repro_torch.core import expr as port_expr
from repro_torch.tpch import ALL_QUERIES
from repro_torch.tpch import generate

SF, SEED = 0.002, 1
CUTOVER_ENV = ("PREDTRACE_DEVICE_CUTOVER", "PREDTRACE_MEMBER_CUTOVER",
               "PREDTRACE_RLE_CUTOVER")


def _as_numpy(db):
    """The reference's tables as plain numpy arrays: dictionary-coded string
    columns go over as their strings."""
    out = {}
    for name, t in db.items():
        cols = {}
        for c, v in t.cols.items():
            cols[c] = (np.asarray(t.dicts[c], dtype=object)[v] if c in t.dicts
                       else np.asarray(v))
        out[name] = cols
    return out


@pytest.fixture(scope="module")
def dbs():
    ref = ref_generate(sf=SF, seed=SEED)
    return ref, catalog_from_numpy(_as_numpy(ref), device="cpu")


@pytest.fixture()
def forced_device(monkeypatch):
    for k in CUTOVER_ENV:
        monkeypatch.setenv(k, "0")


def test_dbgen_matches_reference(dbs):
    ref, handed = dbs
    port = generate(sf=SF, seed=SEED)
    assert sorted(port) == sorted(ref) == sorted(handed)
    for name, rt in ref.items():
        for cand in (port[name], handed[name]):
            assert list(cand.cols) == list(rt.cols), name
            for c, v in rt.cols.items():
                got = np.asarray(cand.cols[c])
                assert got.dtype == v.dtype and np.array_equal(got, v), (name, c)
            assert {k: list(v) for k, v in cand.dicts.items()} == \
                {k: list(v) for k, v in rt.dicts.items()}, name


def _norm(keys):
    """Predicate keys with lineage parameters renamed by first appearance
    (names come from a per-package counter, so only their pattern counts)."""
    names = {}

    def walk(k):
        if isinstance(k, tuple):
            if len(k) == 2 and k[0] in ("param", "pset") and isinstance(k[1], str):
                return (k[0], names.setdefault(k[1], len(names)))
            return tuple(walk(x) for x in k)
        return k

    return walk(keys)


def _plan_keys(pt, key):
    """Everything inference decided, minus plan-node ids (a per-package
    counter): output params, stages (predicate, bound params, guards, column
    projection) and per-table source predicates."""
    lp = pt.lineage_plan

    def params(names):
        return tuple(("param", p) for p in names)

    return _norm((
        tuple(sorted((("param", p), c) for p, c in lp.out_params.items())),
        tuple((key(s.run_pred),
               tuple((("param", p), c) for p, c in s.params_out.items()),
               params(s.guards), s.keep_cols)
              for s in lp.stages),
        tuple((sp.table, key(sp.pred), params(sp.guards))
              for sp in lp.source_preds),
    ))


def _same_answer(a, b):
    assert sorted(a.lineage) == sorted(b.lineage)
    for t in a.lineage:
        assert np.array_equal(np.sort(np.asarray(a.lineage[t])),
                              np.sort(np.asarray(b.lineage[t]))), t
    assert a.precise == b.precise


@pytest.mark.parametrize("qname", sorted(ALL_QUERIES))
def test_query_lineage_matches_reference(dbs, forced_device, qname):
    ref_db, port_db = dbs
    ref_pt = RefPredTrace(ref_db, REF_QUERIES[qname](ref_db))
    port_pt = PredTrace(port_db, ALL_QUERIES[qname](port_db), device="cpu")
    ref_pt.infer()
    port_pt.infer()
    assert _plan_keys(port_pt, port_expr.key) == _plan_keys(ref_pt, ref_expr.key)
    ref_pt.run()
    port_pt.run()
    n = ref_pt.exec_result.output.nrows
    assert port_pt.exec_result.output.nrows == n
    if n == 0:  # empty at this scale: plans and outputs agreed above
        return
    _same_answer(port_pt.query(0), ref_pt.query(0))
    rows = list(range(min(8, n)))
    for a, b in zip(port_pt.query_batch(rows), ref_pt.query_batch(rows)):
        _same_answer(a, b)


def test_main_path_reaches_both_kernel_variants(dbs, forced_device):
    _, port_db = dbs
    for qname, counter in (("q3", "device_scans"), ("q12", "member_fused_scans")):
        pt = PredTrace(port_db, ALL_QUERIES[qname](port_db), device="cpu")
        pt.infer()
        pt.run()
        pt.query(0)
        assert getattr(pt.scan_engine.stats, counter) > 0, qname


def test_store_leg_q3(dbs, forced_device):
    ref_db, port_db = dbs
    ref_pt = RefPredTrace(ref_db, REF_QUERIES["q3"](ref_db), store=True)
    port_pt = PredTrace(port_db, ALL_QUERIES["q3"](port_db), store=True,
                        device="cpu")
    for pt in (ref_pt, port_pt):
        pt.infer()
        pt.run()
    # stages are keyed by plan-node ids (a per-package counter): compare in
    # stage order
    assert list(port_pt.store.encodings().values()) == \
        list(ref_pt.store.encodings().values())
    _same_answer(port_pt.query(0), ref_pt.query(0))
    rows = list(range(min(8, ref_pt.exec_result.output.nrows)))
    for a, b in zip(port_pt.query_batch(rows), ref_pt.query_batch(rows)):
        _same_answer(a, b)


def test_iterative_and_explain_match_reference(dbs, forced_device):
    ref_db, port_db = dbs
    ref_pt = RefPredTrace(ref_db, REF_QUERIES["q10"](ref_db))
    port_pt = PredTrace(port_db, ALL_QUERIES["q10"](port_db), device="cpu")
    for pt in (ref_pt, port_pt):
        pt.infer_iterative()
        pt.run_unmodified()
    _same_answer(port_pt.query_iterative(0), ref_pt.query_iterative(0))
    for pt in (ref_pt, port_pt):
        pt.infer()
        pt.run()
    rep = port_pt.explain(0)
    _same_answer(rep.answer, ref_pt.query(0))
    assert rep.pipeline["backend"] == "TorchBackend"
    assert rep.scans and all(d.actual_s is not None for d in rep.scans)


def test_entry_points_default_to_the_card(dbs, monkeypatch):
    _, port_db = dbs
    plan = ALL_QUERIES["q3"](port_db)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        PredTrace(port_db, plan)
    with pytest.raises(RuntimeError):
        catalog_from_numpy({"t": {"a": np.arange(3)}})
    for kw in ({"parallel": True}, {"mesh": object()},
               {"disk_budget_bytes": None}):
        with pytest.raises(NotImplementedError):
            PredTrace(port_db, plan, device="cpu", **kw)
