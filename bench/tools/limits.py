"""The readings a cell's correctness limits are set from, on the card, in
one process:

* the program on each of ``--seeds`` (its set-up, which drives the
  checked steps through the window's own step and feed), held to the
  float32 reference;
* the control on each of ``--control-seeds``: the reference computed in
  fp8 in the program's place;
* the fault that leaves half of each batch out (the mean taken over the
  rest) on each of ``--fault-seeds``.

    python3 bench/tools/limits.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --fault-seeds 1,2,3

Each reading is a JSON line on standard output.  The benchmark's runs do
not run this; ``PERF.md`` records what it printed and the limits set from
it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))


def seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args()

    import torch

    from benchlib import faults, harness, manifest, program

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    man = manifest.load(BENCH.parent)
    cell = args.workload

    def program_run(seed, fault=None):
        drv = harness.make_driver(man, cell, seed, "cuda")
        undo = faults.planted(program, fault) if fault else None
        try:
            t0 = time.perf_counter()
            drv.setup()
        finally:
            if undo:
                undo()
        drv.free()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        numbers = drv.check()
        return drv, {"setup_s": t1 - t0, "reference_s": time.perf_counter() - t1,
                     **numbers}

    for s in seeds(args.seeds):
        _, rec = program_run(s)
        emit({"cell": cell, "side": "program", "seed": s, **rec})
    for s in seeds(args.fault_seeds):
        _, rec = program_run(s, "half_batch")
        emit({"cell": cell, "side": "half_batch", "seed": s, **rec})
    for s in seeds(args.control_seeds):
        drv = harness.make_driver(man, cell, s, "cuda")
        t0 = time.perf_counter()
        numbers = drv.control()
        emit({"cell": cell, "side": "control_fp8", "seed": s,
              "control_s": time.perf_counter() - t0, **numbers})
    return 0


if __name__ == "__main__":
    sys.exit(main())
