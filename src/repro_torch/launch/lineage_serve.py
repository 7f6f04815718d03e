"""Concurrent lineage serving: LineageService over TPC-H pipelines.

Closed-loop N-client workload against the coalescing scheduler + answer
cache, printing throughput vs serial ``query()``, coalesce width, cache hit
rate, and latency percentiles.  Scans run on the CUDA card unless
``--device cpu`` asks for the kernels' plain PyTorch versions:

  PYTHONPATH=src python -m repro_torch.launch.lineage_serve --smoke
  PYTHONPATH=src python -m repro_torch.launch.lineage_serve --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.lineage_serve \\
      --sf 0.02 --clients 8 --requests 256 --queries q3,q10 --store
"""

from __future__ import annotations

import argparse
import threading
import time
from typing import Dict, List, Tuple

import numpy as np

from ..core import Executor, LineageService, PredTrace
from ..tpch import ALL_QUERIES, generate


def _prepare(db, qname: str, store: bool, num_partitions,
             device=None) -> PredTrace:
    plan = ALL_QUERIES[qname](db)
    res = Executor(db, device=device).run(plan)
    pt = PredTrace(db, plan, store=store or None,
                   num_partitions=num_partitions, device=device)
    pt.infer(stats=res.stats)
    pt.run()
    return pt


def workload(pts: Dict[str, PredTrace], n: int, zipf_a: float,
             seed: int) -> List[Tuple[str, int]]:
    """``n`` (pipeline, output row) requests: pipelines in turn, rows drawn
    Zipf(``zipf_a``) over each pipeline's output rows (hot rows first)."""
    rng = np.random.default_rng(seed)
    names = sorted(pts)
    reqs = []
    for i in range(n):
        q = names[i % len(names)]
        nr = pts[q].exec_result.output.nrows
        ranks = np.arange(1, nr + 1, dtype=np.float64) ** -zipf_a
        reqs.append((q, int(rng.choice(nr, p=ranks / ranks.sum()))))
    return reqs


def serve(svc: LineageService, reqs: List[Tuple[str, int]],
          clients: int = 4, burst: int = 16) -> List[object]:
    """Closed-loop run of ``reqs`` through ``svc``: ``clients`` threads take
    the requests in turn and submit them in pages of ``burst``
    (``submit_many`` per pipeline), each page awaited before the next.
    Returns the answers in request order; a client's error is raised
    here."""
    answers: Dict[int, object] = {}
    errors: List[BaseException] = []

    def client(cid: int):
        try:
            mine = list(range(cid, len(reqs), clients))
            for j in range(0, len(mine), burst):
                page = mine[j:j + burst]
                by_pipe: Dict[str, List[int]] = {}
                for i in page:
                    by_pipe.setdefault(reqs[i][0], []).append(i)
                handles = []
                for q, idxs in by_pipe.items():
                    hs = svc.submit_many([reqs[i][1] for i in idxs], q,
                                         timeout=300)
                    handles.extend(zip(idxs, hs))
                for i, h in handles:
                    answers[i] = h.result()
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if errors:
        raise errors[0]
    assert len(answers) == len(reqs), "client threads hung"
    return [answers[i] for i in range(len(reqs))]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sf", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--queries", default="q3,q10")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--burst", type=int, default=16,
                    help="requests each client submits per page")
    ap.add_argument("--zipf", type=float, default=1.5,
                    help="hot-row skew of the request distribution")
    ap.add_argument("--window-ms", type=float, default=3.0)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--store", action="store_true",
                    help="serve from compressed intermediate stores")
    ap.add_argument("--partitions", type=int, default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny preset: sf=0.005, 64 requests")
    ap.add_argument("--device", default=None,
                    help="torch device of the scans (default: the CUDA card; "
                         "'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.sf, args.requests = 0.005, 64

    print(f"[lineage-serve] generating TPC-H sf={args.sf} seed={args.seed}")
    db = generate(sf=args.sf, seed=args.seed)
    pts: Dict[str, PredTrace] = {}
    for q in args.queries.split(","):
        pt = _prepare(db, q, args.store, args.partitions, args.device)
        if pt.exec_result.output.nrows:
            pts[q] = pt
    reqs = workload(pts, args.requests, args.zipf, args.seed)
    print(f"[lineage-serve] {len(pts)} pipelines, {len(reqs)} requests, "
          f"{len(set(reqs))} distinct questions, {args.clients} clients")

    # serial baseline (warm)
    for pt in pts.values():
        pt.query(0)
    t0 = time.perf_counter()
    serial = [pts[q].query(r) for q, r in reqs]
    serial_s = time.perf_counter() - t0

    with LineageService(pts, max_batch=args.max_batch,
                        window_s=args.window_ms / 1e3) as svc:
        t0 = time.perf_counter()
        answers = serve(svc, reqs, args.clients, args.burst)
        service_s = time.perf_counter() - t0
    st = svc.stats()

    def key(ans):
        return {t: set(np.asarray(v).tolist()) for t, v in ans.lineage.items()}

    identical = all(key(answers[i]) == key(serial[i]) for i in range(len(reqs)))
    for pt in pts.values():
        pt.close()

    print(f"[lineage-serve] serial {serial_s*1e3:.1f} ms | service "
          f"{service_s*1e3:.1f} ms | throughput {serial_s/service_s:.2f}x | "
          f"identical answers: {identical}")
    print(f"[lineage-serve] coalesce width avg={st['coalesce_width_avg']:.1f} "
          f"max={st['coalesce_width_max']} over {st['batches']} batches; "
          f"cache hit rate {st['cache_hit_rate']:.0%} "
          f"(stale={st['cache_stale']})")
    print(f"[lineage-serve] latency p50={st['latency_ms_p50']:.2f} ms "
          f"p99={st['latency_ms_p99']:.2f} ms; "
          f"answered={st['answered']} expired={st['expired']} "
          f"failed={st['failed']}")
    assert identical, "service answers diverged from serial query()"
    return st


if __name__ == "__main__":
    main()
