"""The regression corpus (``tests/corpus/*.json``) through both packages.

Each descriptor is built twice by ``pipeline_cases``'s own builder: once as
it stands (the reference's modules) and once with its functions rebound to
the port's ``ops``, ``expr`` and ``Table``, so both packages run the same
operator trees and the same UDF bodies.  The port runs on ``device="cpu"``
with its device cutovers forced to 0, so every in-fragment scan goes
through the kernels' plain PyTorch versions.  ``query``, ``query_batch``,
``query_naive`` and ``query_iterative`` must give identical lineage row sets
and ``precise`` flags.
"""

from __future__ import annotations

import json
import types
from pathlib import Path

import numpy as np
import pytest

import pipeline_cases
from repro.core import Executor as RefExecutor
from repro.core import PredTrace as RefPredTrace
from repro_torch.core import Executor, PredTrace
from repro_torch.core import expr as port_expr
from repro_torch.core import ops as port_ops
from repro_torch.core.table import Table as PortTable

CORPUS = sorted((Path(__file__).parent / "corpus").glob("*.json"))
CUTOVER_ENV = ("PREDTRACE_DEVICE_CUTOVER", "PREDTRACE_MEMBER_CUTOVER",
               "PREDTRACE_RLE_CUTOVER")


def _port_builders():
    """``build_catalog`` and ``build_plan`` of ``pipeline_cases`` with their
    module globals swapped for the port's modules."""
    g = dict(vars(pipeline_cases))
    g.update(O=port_ops, Col=port_expr.Col,
             LineageAnnotation=port_expr.LineageAnnotation, Table=PortTable)

    def rebind(fn):
        return types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__)

    g["_apply"] = rebind(pipeline_cases._apply)
    return rebind(pipeline_cases.build_catalog), rebind(pipeline_cases.build_plan)


def _answers(pt, row):
    """(lineage sets, precise flags) of the four query routes for one row."""
    (batched,) = pt.query_batch([row])
    out = {}
    for name, ans in (("query", pt.query(row)), ("query_batch", batched),
                      ("query_naive", pt.query_naive(row)),
                      ("query_iterative", pt.query_iterative(row))):
        out[name] = (pipeline_cases.lineage_sets(ans.lineage), dict(ans.precise))
    return out


def test_corpus_builders_target_the_port():
    build_catalog, build_plan = _port_builders()
    case = json.loads(CORPUS[0].read_text())
    assert all(isinstance(t, PortTable)
               for t in build_catalog(case["catalog"]).values())
    plan = build_plan(case["ops"])
    assert type(plan).__module__ == port_ops.__name__


@pytest.mark.parametrize("path", CORPUS, ids=lambda p: p.stem)
def test_corpus_case_matches_reference(path, monkeypatch):
    for k in CUTOVER_ENV:
        monkeypatch.setenv(k, "0")
    case = json.loads(path.read_text())
    build_catalog, build_plan = _port_builders()

    ref_cat = pipeline_cases.build_catalog(case["catalog"])
    ref_plan = pipeline_cases.build_plan(case["ops"])
    ref_res = RefExecutor(ref_cat).run(ref_plan)
    assert ref_res.output.nrows > 0
    row = case["row"] % ref_res.output.nrows
    ref_pt = RefPredTrace(ref_cat, ref_plan)
    ref_pt.infer(stats=ref_res.stats)
    ref_pt.run()

    cat = build_catalog(case["catalog"])
    plan = build_plan(case["ops"])
    res = Executor(cat, device="cpu").run(plan)
    assert res.output.nrows == ref_res.output.nrows
    for c in ref_res.output.columns:
        np.testing.assert_array_equal(np.asarray(res.output.cols[c]),
                                      np.asarray(ref_res.output.cols[c]))
    pt = PredTrace(cat, plan, device="cpu")
    pt.infer(stats=res.stats)
    pt.run()

    assert _answers(pt, row) == _answers(ref_pt, row)
