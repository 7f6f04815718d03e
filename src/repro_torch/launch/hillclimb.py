"""§Perf hillclimbing: re-traces a cell under named variants
(sharding rules / config overrides) with the dry run's ``run_cell`` and
reports the roofline deltas.

  python -m repro_torch.launch.hillclimb --cell qwen2_train
  python -m repro_torch.launch.hillclimb --all
"""

import argparse
import json
from pathlib import Path

from .dryrun import run_cell

# Each experiment: (variant name, kwargs for run_cell).
# Baselines ({} variant) re-measure with the same code path for a clean A/B.
EXPERIMENTS = {
    # Cell A — worst roofline fraction: qwen2's 14 heads / 2 KV heads don't
    # divide the 16-way model axis -> baseline replicates attention 16x.
    "qwen2_train": {
        "arch": "qwen2-0.5b", "shape": "train_4k", "multi_pod": False,
        "variants": [
            # baseline comes from the sweep artifact
            # H1: shard attention over query positions instead (seq_q rule)
            ("seq_q_shard", {"rules": {"seq_q": "model"}}),
        ],
    },
    # Cell B — most collective-bound: granite's 4-microbatch accumulation
    # re-gathers FSDP weights and SP activations every microbatch.
    "granite_train": {
        "arch": "granite-34b", "shape": "train_4k", "multi_pod": False,
        "variants": [
            # baseline comes from the sweep artifact (accum_steps=4)
            # H1: halve microbatches (memory headroom says we can)
            ("accum2", {"cfg_overrides": {"accum_steps": 2}}),
        ],
    },
    # Cell C — the paper-representative cell: MoE dispatch is the framework's
    # relational scatter/gather; EP-vs-TP is the collective-layout decision.
    "mixtral_train": {
        "arch": "mixtral-8x22b", "shape": "train_4k", "multi_pod": False,
        "variants": [
            # baseline (TP experts) comes from the sweep artifact
            # H1: expert parallelism — experts sharded over the model axis
            ("ep", {"rules": {"experts": "model"}}),
            # H2: more microbatches to fit single-pod HBM
            ("accum8", {"cfg_overrides": {"accum_steps": 8}}),
        ],
    },
}


def run_experiment(name: str, outdir: Path):
    exp = EXPERIMENTS[name]
    results = []
    for vname, kw in exp["variants"]:
        print(f"=== {name}/{vname}")
        cell = run_cell(
            exp["arch"], exp["shape"], exp["multi_pod"],
            fsdp=kw.get("fsdp", True), rules=kw.get("rules"),
            cfg_overrides=kw.get("cfg_overrides"), verbose=False,
        )
        r = cell["roofline"]
        print(
            f"  dom={r['dominant']} comp={r['compute_s']:.4f}s mem={r['memory_s']:.4f}s "
            f"coll={r['collective_s']:.4f}s GiB={cell['per_device_bytes']/2**30:.2f} "
            f"fits={cell['fits_hbm']}"
        )
        cell["variant"] = vname
        results.append(cell)
        (outdir / f"{name}_{vname}.json").write_text(json.dumps(cell, indent=2, default=str))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", type=str, default=None, choices=sorted(EXPERIMENTS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default="experiments/hillclimb")
    args = ap.parse_args(argv)
    if not args.all and args.cell is None:
        ap.error("--cell or --all")
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    names = list(EXPERIMENTS) if args.all else [args.cell]
    for n in names:
        run_experiment(n, outdir)


if __name__ == "__main__":
    main()
