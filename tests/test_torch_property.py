"""The full-algebra fuzzers of ``tests/test_property.py`` through both
packages.

Hypothesis draws a catalog descriptor (``full_catalog_desc``) and an op list
(``full_ops_strategy``, relational and with annotated UDF nodes); both
packages build them with ``pipeline_cases``'s builder (the port's build
rebinds its globals to the port's modules, as ``tests/test_torch_corpus.py``
does) and answer the same output row.  The port runs on ``device="cpu"``
with its device cutovers forced to 0 and one configuration drawn from
budgets {None, partial, 0} x partitions {None, 4}, plus a worker pool
(``parallel=2``).  ``query``, ``query_batch``, ``query_naive`` and
``query_iterative`` must give the reference's lineage row sets and
``precise`` flags (the reference runs the same configuration), and the
port's eager oracle must equal the reference's.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

import pipeline_cases
from repro.core import Executor as RefExecutor
from repro.core import PredTrace as RefPredTrace
from repro.core.eager import oracle_lineage_for_values as ref_oracle
from repro_torch.core import Executor, PredTrace, oracle_lineage_for_values
from test_torch_corpus import _port_builders
from test_torch_lineage_tpch import CUTOVER_ENV

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402
from test_property import full_catalog_desc, full_ops_strategy  # noqa: E402

CONFIGS = [
    {"budget": None}, {"budget": "partial"}, {"budget": 0},
    {"budget": None, "num_partitions": 4},
    {"budget": "partial", "num_partitions": 4},
    {"budget": 0, "num_partitions": 4},
    {"budget": None, "num_partitions": 4, "parallel": 2},
]


def sets(lineage):
    return {k: set(np.asarray(v).tolist()) for k, v in lineage.items() if len(v)}


def prepared(cls, res, cat, plan, budget, **kw):
    if budget == "partial":
        probe = cls(cat, plan, store=True, **kw)
        probe.infer(stats=res.stats)
        probe.run()
        kw["budget_bytes"] = max(probe.store.nbytes() // 2, 1)
        probe.close()
    elif budget is not None:
        kw["budget_bytes"] = budget
    pt = cls(cat, plan, **kw)
    pt.infer(stats=res.stats)
    pt.run()
    return pt


def answers(pt, row):
    (batched,) = pt.query_batch([row])
    out = [pt.query(row), batched, pt.query_naive(row),
           pt.query_iterative(row)]
    return [(sets(a.lineage), dict(a.precise)) for a in out]


def check_both(cat_desc, ops, row_seed, config):
    config = dict(config)
    budget = config.pop("budget")
    build_catalog, build_plan = _port_builders()
    ref_cat = pipeline_cases.build_catalog(cat_desc)
    ref_plan = pipeline_cases.build_plan(ops)
    ref_res = RefExecutor(ref_cat).run(ref_plan)
    cat, plan = build_catalog(cat_desc), build_plan(ops)
    res = Executor(cat, device="cpu").run(plan)
    assert res.output.nrows == ref_res.output.nrows
    if res.output.nrows == 0:
        return
    row = row_seed % res.output.nrows
    values = {c: res.output.cols[c][row] for c in res.output.columns}
    ref_values = {c: ref_res.output.cols[c][row]
                  for c in ref_res.output.columns}
    assert sets(oracle_lineage_for_values(cat, plan, values)) == \
        sets(ref_oracle(ref_cat, ref_plan, ref_values))
    ref_kw = {k: v for k, v in config.items() if k == "num_partitions"}
    ref_pt = prepared(RefPredTrace, ref_res, ref_cat, ref_plan, budget, **ref_kw)
    pt = prepared(PredTrace, res, cat, plan, budget, device="cpu", **config)
    try:
        assert answers(pt, row) == answers(ref_pt, row)
    finally:
        pt.close()
        ref_pt.close()


def forced(fn):
    """Runs ``fn`` with the device cutovers at 0 (hypothesis runs many
    examples per test call, so the environment is set around each)."""
    def run(*a, **kw):
        saved = {k: os.environ.get(k) for k in CUTOVER_ENV}
        os.environ.update({k: "0" for k in CUTOVER_ENV})
        try:
            fn(*a, **kw)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return run


@settings(max_examples=25, deadline=None)
@given(cat_desc=full_catalog_desc(), ops=full_ops_strategy(),
       row_seed=st.integers(0, 10**6), config=st.sampled_from(CONFIGS))
def test_full_algebra_matches_reference(cat_desc, ops, row_seed, config):
    forced(check_both)(cat_desc, ops, row_seed, config)


@settings(max_examples=25, deadline=None)
@given(cat_desc=full_catalog_desc(), ops=full_ops_strategy(with_udfs=True),
       row_seed=st.integers(0, 10**6), config=st.sampled_from(CONFIGS))
def test_udf_algebra_matches_reference(cat_desc, ops, row_seed, config):
    forced(check_both)(cat_desc, ops, row_seed, config)


@pytest.mark.parametrize("config", CONFIGS,
                         ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_every_config_on_a_fixed_udf_pipeline(config):
    """Each configuration at least once, whatever hypothesis draws: a
    window, a map UDF and a join under a group-by over the UDF column."""
    cat_desc = {"r": {"idx": list(range(10)), "a": [0, 1, 2, 3, 4, 5, 0, 1, 2, 3],
                      "b": [1, 1, 2, 2, 3, 3, 4, 4, 5, 5],
                      "v": [5, 12, 33, 7, 41, 18, 26, 3, 49, 30]},
                "s": {"c": [0, 2, 4, 1, 3], "w": [10, 20, 30, 40, 50]}}
    ops = [["window", 3], ["map_udf", 3], ["join", "inner"],
           ["groupby_m", "sum"]]
    for row_seed in range(3):
        forced(check_both)(cat_desc, ops, row_seed, config)


def test_shared_union_subtree_keeps_every_stage_column():
    """The input ``tests/test_property.py::test_udf_algebra_differential``
    replays: both union branches read one materialized node, whose column
    projection kept only one branch's columns, so ``query`` raised
    ``KeyError: 'a'`` in ``_stage_select``.  The port keeps the union of
    the columns its stages need and answers as its eager oracle does; the
    reference still raises on it."""
    cat_desc = {"r": {"idx": [0, 1, 2, 3], "a": [0] * 4, "b": [0] * 4,
                      "v": [0] * 4},
                "s": {"c": [0] * 3, "w": [0] * 3}}
    ops = [["window", 2], ["rowtransform", 0], ["map_udf", 2], ["union", 5, 5],
           ["groupby", "sum"]]
    build_catalog, build_plan = _port_builders()
    cat, plan = build_catalog(cat_desc), build_plan(ops)
    res = Executor(cat, device="cpu").run(plan)
    values = {c: res.output.cols[c][0] for c in res.output.columns}
    want = sets(oracle_lineage_for_values(cat, plan, values))
    assert want == {"r": {0, 1, 2, 3}}
    pt = PredTrace(cat, plan, device="cpu")
    pt.infer(stats=res.stats)
    pt.run()
    try:
        ans = pt.query(0)
        assert sets(ans.lineage) == want and ans.all_precise()
        (batched,) = pt.query_batch([0])
        assert sets(batched.lineage) == want
        for superset in (pt.query_naive(0), pt.query_iterative(0)):
            got = sets(superset.lineage)
            assert all(want[t] <= got.get(t, set()) for t in want)
    finally:
        pt.close()

    ref_cat = pipeline_cases.build_catalog(cat_desc)
    ref_plan = pipeline_cases.build_plan(ops)
    ref_pt = RefPredTrace(ref_cat, ref_plan)
    ref_pt.infer(stats=RefExecutor(ref_cat).run(ref_plan).stats)
    ref_pt.run()
    with pytest.raises(KeyError):
        ref_pt.query(0)
    ref_pt.close()
