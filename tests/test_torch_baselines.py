"""The port's eager oracle, the paper's lazy baselines, the symbolic verifier
and the explain CLI against the JAX package's.

``tests/test_baselines.py`` through both packages on the same TPC-H catalog
(sf 0.002): the coverage profile (PredTrace 22, Trace 12, Panda 5), each
baseline's answer against the eager oracle, and the GProM witness budget;
the port's ``oracle_lineage_for_values`` against the reference's; the
``symbolic_check`` cases of ``tests/test_pushdown_rules.py`` on both
packages' operator trees; ``tests/test_explain.py::
test_parallel_route_recorded`` on the port; and
``python -m repro_torch.launch.explain --device cpu`` run once.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_incremental import BOTH, PORT, REF, forced_device  # noqa: F401
from test_torch_lineage_tpch import _as_numpy

from repro.core import baselines as ref_baselines
from repro.core import eager as ref_eager
from repro.core import verify as ref_verify
from repro.core.pushdown import Pushdown as RefPushdown
from repro_torch.core import baselines as port_baselines
from repro_torch.core import eager as port_eager
from repro_torch.core import verify as port_verify
from repro_torch.core.pushdown import Pushdown as PortPushdown

BASE = {REF: ref_baselines, PORT: port_baselines}
EAGER = {REF: ref_eager, PORT: port_eager}
VERIFY = {REF: ref_verify, PORT: port_verify}
PUSHDOWN = {REF: RefPushdown, PORT: PortPushdown}
SRC = str(Path(__file__).resolve().parent.parent / "src")


@pytest.fixture(scope="module")
def dbs():
    from repro.tpch import generate

    ref = generate(sf=0.002, seed=1)
    return {REF: ref,
            PORT: PORT.table.catalog_from_numpy(_as_numpy(ref), device="cpu")}


def lineage_sets(lin):
    return {k: set(np.asarray(list(v) if isinstance(v, frozenset) else v)
                   .tolist()) for k, v in lin.items() if len(v)}


def first_row(pkg, db, qname):
    plan = pkg.queries[qname](db)
    out = pkg.Executor(db).run(plan).output
    return plan, out, {c: out.cols[c][0] for c in out.columns}


@pytest.mark.parametrize("qname", ["q1", "q3", "q4", "q6", "q10", "q12"])
def test_oracle_matches_reference(dbs, qname):
    got = {}
    for pkg in BOTH:
        plan, out, values = first_row(pkg, dbs[pkg], qname)
        assert out.nrows > 0
        got[pkg] = lineage_sets(EAGER[pkg].oracle_lineage_for_values(
            dbs[pkg], plan, values))
    assert got[PORT] == got[REF] and got[PORT]


@pytest.mark.parametrize("qname", ["q1", "q3", "q6", "q10"])
def test_baselines_match_oracle_on_supported(dbs, qname):
    plan, out, values = first_row(PORT, dbs[PORT], qname)
    oracle = lineage_sets(port_eager.oracle_lineage_for_values(
        dbs[PORT], plan, values))
    ran = 0
    for cls in (port_baselines.TraceBaseline, port_baselines.RewriteBaseline,
                port_baselines.PandaBaseline):
        b = cls(dbs[PORT], plan)
        if not b.supports():
            continue
        b.prepare()
        assert lineage_sets(b.query(out, 0).lineage) == oracle, b.name
        ran += 1
    assert ran >= 2


def test_gprom_handles_nested(dbs):
    plan, out, values = first_row(PORT, dbs[PORT], "q4")
    oracle = lineage_sets(port_eager.oracle_lineage_for_values(
        dbs[PORT], plan, values))
    b = port_baselines.RewriteBaseline(dbs[PORT], plan)
    b.prepare()
    assert lineage_sets(b.query(out, 0).lineage) == oracle


def test_coverage_profile(dbs):
    """Paper Table 4: PredTrace 22/22; Trace 12 (non-nested only); Panda 5
    (single SELECT block: q1/3/5/6/10) — in both packages."""
    for pkg in BOTH:
        db, B = dbs[pkg], BASE[pkg]
        trace = sorted(q for q, qf in pkg.queries.items()
                       if B.TraceBaseline(db, qf(db)).supports())
        panda = sorted(q for q, qf in pkg.queries.items()
                       if B.PandaBaseline(db, qf(db)).supports())
        assert len(trace) == 12
        assert panda == ["q1", "q10", "q3", "q5", "q6"]
        if pkg is PORT:
            assert trace == ref_trace
        ref_trace = trace
    for qf in PORT.queries.values():
        PORT.PredTrace(dbs[PORT], qf(dbs[PORT])).infer()
    assert len(PORT.queries) == 22


@pytest.mark.parametrize("qname", ["q3", "q4"])
def test_gprom_witness_budget(dbs, qname):
    """A witness budget below the joins' row count raises ``Unsupported``
    (the paper's time cutoff), in both packages."""
    for pkg in BOTH:
        plan, out, _ = first_row(pkg, dbs[pkg], qname)
        b = BASE[pkg].RewriteBaseline(dbs[pkg], plan, witness_budget=10)
        with pytest.raises(BASE[pkg].Unsupported):
            b.query(out, 0)


# --------------------------------------------------------------------------- #
# symbolic_check (tests/test_pushdown_rules.py's cases)
# --------------------------------------------------------------------------- #

SCHEMAS = {"r": ["a", "b", "v"], "s": ["c", "w"]}


def verify_cases(pkg):
    """(name, node, F, verdict): the join family gets a verdict; other
    operators are outside the verifier's fragment (None)."""
    O, E = pkg.ops, pkg.expr
    Col, Param = E.Col, E.Param
    j = O.InnerJoin(O.Source("r"), O.Source("s"), [("a", "c")])
    lo = O.LeftOuterJoin(O.Source("r"), O.Source("s"), [("a", "c")])
    semi = O.SemiJoin(O.Source("r"), O.Source("s"), [("a", "c")])
    anti = O.AntiJoin(O.Source("r"), O.Source("s"), [("a", "c")])
    g = O.GroupBy(O.Source("r"), ["b"], {"s": O.Agg("sum", Col("v"))})
    frow, _ = E.row_selection_for(SCHEMAS["r"])
    pinned = E.land(Col("a").eq(Param("x")), Col("w").eq(Param("y")))
    return [
        ("join_key_pinned", j, pinned, True),
        ("join_key_free", j, Col("v").eq(Param("x")), False),
        ("left_join_key_pinned", lo, pinned, True),
        ("left_join_key_free", lo, Col("v").eq(Param("x")), False),
        ("semijoin_key_free", semi, Col("b").eq(Param("g")), False),
        ("semijoin_row_selection", semi, frow, True),
        ("antijoin_row_selection", anti, frow, True),
        ("groupby_outside_fragment", g, Col("s").eq(Param("sv")), None),
    ]


@pytest.mark.parametrize("case", range(8), ids=lambda i: [
    "join_key_pinned", "join_key_free", "left_join_key_pinned",
    "left_join_key_free", "semijoin_key_free", "semijoin_row_selection",
    "antijoin_row_selection", "groupby_outside_fragment"][i])
def test_symbolic_check_matches_reference(case):
    got = {}
    for pkg in BOTH:
        name, node, F, want = verify_cases(pkg)[case]
        got[pkg] = VERIFY[pkg].symbolic_check(PUSHDOWN[pkg](node, SCHEMAS),
                                              node, F)
        assert got[pkg] is want, (name, pkg)
    assert got[PORT] is got[REF]


# --------------------------------------------------------------------------- #
# explain
# --------------------------------------------------------------------------- #

def test_parallel_route_recorded(dbs, monkeypatch):
    """On the numpy backend a pooled PredTrace fans surviving partitions
    out, and explain() records the parallel route with its estimate and
    measured time (the torch backend carries scans instead; its pool never
    launches)."""
    monkeypatch.setenv("PREDTRACE_PARALLEL_CUTOVER", "0")
    PORT.dispatch.reset_for_tests()
    db = dbs[PORT]
    plan = PORT.queries["q3"](db)
    res = PORT.Executor(db).run(plan)
    pt = PORT.PredTrace(db, plan, num_partitions=16, parallel=2,
                        scan_engine=PORT.scan.ScanEngine("numpy"))
    pt.infer(stats=res.stats)
    pt.run()
    try:
        rep = pt.explain(0)
        decs = [d for d in rep.scans if d.chosen == "parallel"]
        assert decs, sorted({d.chosen for d in rep.scans})
        for d in decs:
            assert d.est_s > 0.0
            assert d.actual_s is not None and d.actual_s > 0.0
            assert d.candidates
        assert rep.pipeline["parallel"] is True
    finally:
        pt.close()
        PORT.dispatch.reset_for_tests()


def test_explain_cli_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.explain", "--smoke",
         "--device", "cpu", "--queries", "q3", "--partitions", "8",
         "--parallel", "2"],
        env=dict(os.environ, PYTHONPATH=SRC),
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert "=== q3 row 0 ===" in proc.stdout
    assert "routes:" in proc.stdout
