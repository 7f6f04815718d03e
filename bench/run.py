"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with at least the cards the cell
asks for.  It makes the cell's weights and inputs from ``--seed`` on the
card, builds the port's objects and warms up every shape the cell uses
(``setup_s``, counted from the start of this process), measures for
``--seconds``, and checks what the timed path produced against the plain
reference (``bench/reference``).  With ``--trace 0`` the metrics are the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics, read
by ``bench/metrics/<metric>.py`` from the window and from a profiled part
after it.  The last line of standard output is one JSON object; the
numbers compared and their limits end standard error.

It exits non-zero, printing no result, without a CUDA card, with fewer
cards than the cell asks for, or when JAX or the JAX package was loaded.
Every build and kernel cache stays inside the checkout, under ``build/``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / "build" / "bench-cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Caches at fixed paths inside the checkout, the port on the path,
    one CPU thread for PyTorch's own pool, and no library left to load JAX
    by itself."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    # one process, few threads: the host dispatches the card's work, and
    # idle CPU threads spinning beside it only add noise
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)


def loaded_forbidden() -> list:
    """Top-level names of JAX, its libraries or the JAX package among the
    loaded modules, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    from benchlib import harness, manifest

    man = manifest.load(ROOT)
    if args.workload not in man.cells:
        print(f"unknown workload {args.workload}; have {sorted(man.cells)}", file=sys.stderr)
        return 2
    chips = man.cells[args.workload].chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = harness.run_cell(man, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"the run loaded {bad}: the benchmark runs the port alone", file=sys.stderr)
        return 4
    harness.print_check(result["check"])
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
