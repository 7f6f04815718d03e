"""Lineage plan explainer: pretty-print ``PredTrace.explain()`` reports.

Runs TPC-H pipelines, explains lineage queries for a few output rows, and
prints each :class:`~repro_torch.core.cost.PlanReport` — the plan
alternatives considered per table, every scan-dispatch decision with
estimated vs measured cost, and the cost-model summary.  ``--warm N`` runs N
unrecorded queries first so the model's online-learned slopes (not just the
seeded cutovers) are what the report shows.  Scans run on the CUDA card
unless ``--device cpu`` asks for the kernels' plain PyTorch versions:

  PYTHONPATH=src python -m repro_torch.launch.explain --smoke
  PYTHONPATH=src python -m repro_torch.launch.explain --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.explain \\
      --sf 0.02 --queries q3,q10 --rows 3 --store --partitions 32 --warm 8
  PYTHONPATH=src python -m repro_torch.launch.explain --queries q3 --json
"""

from __future__ import annotations

import argparse
import json

from ..core import Executor, PredTrace
from ..tpch import ALL_QUERIES, generate


def _prepare(db, qname: str, args) -> PredTrace:
    plan = ALL_QUERIES[qname](db)
    res = Executor(db, device=args.device).run(plan)
    pt = PredTrace(db, plan,
                   store=args.store or (args.budget is not None) or None,
                   budget_bytes=args.budget,
                   num_partitions=args.partitions,
                   parallel=args.parallel or None,
                   device=args.device)
    pt.infer(stats=res.stats)
    pt.run()
    return pt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sf", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--queries", default="q3,q10")
    ap.add_argument("--rows", type=int, default=2,
                    help="output rows to explain per pipeline")
    ap.add_argument("--warm", type=int, default=0,
                    help="unrecorded warm-up queries before explaining")
    ap.add_argument("--store", action="store_true",
                    help="query from compressed intermediate stores")
    ap.add_argument("--budget", type=int, default=None,
                    help="store byte budget (implies --store)")
    ap.add_argument("--partitions", type=int, default=None)
    ap.add_argument("--parallel", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device of the scans (default: the CUDA card; "
                         "'cpu' runs the kernels' plain PyTorch versions)")
    ap.add_argument("--json", action="store_true",
                    help="emit reports as JSON instead of the pretty view")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny preset: sf=0.005, one row per pipeline")
    args = ap.parse_args(argv)
    if args.smoke:
        args.sf, args.rows = 0.005, 1

    print(f"[explain] generating TPC-H sf={args.sf} seed={args.seed}")
    db = generate(sf=args.sf, seed=args.seed)
    for q in args.queries.split(","):
        pt = _prepare(db, q, args)
        nr = pt.exec_result.output.nrows
        if not nr:
            print(f"[explain] {q}: empty output at sf={args.sf}, skipped")
            continue
        for r in range(min(args.warm, nr)):
            pt.query(r)
        for r in range(min(args.rows, nr)):
            rep = pt.explain(r)
            print(f"\n=== {q} row {r} ===")
            print(json.dumps(rep.to_dict(), indent=2, sort_keys=True,
                             default=str) if args.json else rep.pretty())
        pt.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
