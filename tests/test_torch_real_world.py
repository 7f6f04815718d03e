"""The real-world UDF pipelines (``tests/real_world_cases.py``) through both
packages — the paper's coverage claim, on the port.

Each case's builder is run twice: as it stands (the reference's modules)
and with its globals rebound to the port's ``ops``, ``expr`` and ``Table``,
so both packages run the same operator trees and the same UDF bodies.  The
port runs on ``device="cpu"`` with its device cutovers forced to 0.  Under
every (budget, partitioning) configuration of ``tests/test_real_world.py``
— budgets {None, partial, 0} x partitions {None, 4} — and with a worker
pool (``parallel=2``) and a CPU mesh, ``query``, ``query_batch`` and
``query_iterative`` must give the reference's lineage row sets and
``precise`` flags, and the port's eager oracle must equal the reference's.
"""

from __future__ import annotations

import types

import numpy as np
import pytest

import real_world_cases
from real_world_cases import CASES
from repro.core import Executor as RefExecutor
from repro.core import PredTrace as RefPredTrace
from repro.core.eager import oracle_lineage_for_values as ref_oracle
from repro_torch.core import Executor, PredTrace, oracle_lineage_for_values
from repro_torch.core import expr as port_expr
from repro_torch.core import ops as port_ops
from repro_torch.core.table import Table as PortTable
from test_torch_lineage_tpch import CUTOVER_ENV

BUDGETS = [None, "partial", 0]
PARTITIONS = [None, 4]


@pytest.fixture(autouse=True)
def forced_device(monkeypatch):
    for k in CUTOVER_ENV:
        monkeypatch.setenv(k, "0")


def port_build(case):
    """``case.build`` with its module globals swapped for the port's."""
    g = dict(vars(real_world_cases))
    g.update(O=port_ops, Col=port_expr.Col,
             LineageAnnotation=port_expr.LineageAnnotation, Table=PortTable)
    fn = case.build
    return types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__,
                              fn.__closure__)


def sets(lineage):
    return {k: set(np.asarray(v).tolist()) for k, v in lineage.items() if len(v)}


def prepared(cls, exec_cls, cat, plan, budget, **kw):
    """(PredTrace, ExecResult) under ``budget`` as ``run_case`` sets it:
    ``"partial"`` is half the full encoded store of the same package."""
    res = exec_cls(cat).run(plan)
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
    return pt, res


def answers(pt, rows):
    out = {"query": [pt.query(r) for r in rows],
           "query_batch": pt.query_batch(rows)}
    out["query_iterative"] = [pt.query_iterative(r) for r in rows]
    return {k: [(sets(a.lineage), dict(a.precise)) for a in v]
            for k, v in out.items()}


def run_both(case, budget, **port_kw):
    ref_cat, ref_plan = case.build()
    ref_pt, ref_res = prepared(RefPredTrace, RefExecutor, ref_cat, ref_plan,
                               budget, **{k: v for k, v in port_kw.items()
                                          if k == "num_partitions"})
    cat, plan = port_build(case)()
    pt, res = prepared(PredTrace, lambda c: Executor(c, device="cpu"), cat,
                       plan, budget, device="cpu", **port_kw)
    assert res.output.nrows == ref_res.output.nrows > 0
    if budget == "partial":
        assert pt.budget_bytes == ref_pt.budget_bytes
    rows = list(range(min(res.output.nrows, case.check_rows)))
    want = answers(ref_pt, rows)
    got = answers(pt, rows)
    pt.close()
    ref_pt.close()
    return got, want


@pytest.mark.parametrize("parts", PARTITIONS,
                         ids=lambda p: "part" if p else "flat")
@pytest.mark.parametrize("budget", BUDGETS,
                         ids=lambda b: {None: "budget_none", 0: "budget_0",
                                        "partial": "budget_partial"}[b])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_real_world_matches_reference(case, budget, parts):
    got, want = run_both(case, budget, num_partitions=parts)
    assert got == want


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_real_world_parallel_and_mesh_match_reference(case):
    """A pool of two workers over four partitions, and a two-shard CPU mesh,
    answer as the reference's unpooled PredTrace does."""
    _, want = run_both(case, None, num_partitions=4)
    for kw in ({"num_partitions": 4, "parallel": 2},
               {"mesh": ("cpu", "cpu")}):
        got, _ = run_both(case, None, **kw)
        assert got == want, kw


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_real_world_oracle_matches_reference(case):
    ref_cat, ref_plan = case.build()
    cat, plan = port_build(case)()
    ref_out = RefExecutor(ref_cat).run(ref_plan).output
    out = Executor(cat, device="cpu").run(plan).output
    for row in range(min(out.nrows, case.check_rows)):
        values = {c: out.cols[c][row] for c in out.columns}
        ref_values = {c: ref_out.cols[c][row] for c in ref_out.columns}
        got = sets(oracle_lineage_for_values(cat, plan, values))
        assert got == sets(ref_oracle(ref_cat, ref_plan, ref_values))
        assert got, (case.name, row)
