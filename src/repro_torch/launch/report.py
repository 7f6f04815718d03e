"""Render the §Roofline markdown table from dry-run artifacts.

The reference's table from the same ``summary.json``, but for the HBM
column, which holds a cell against the H100's 80 GB (``dryrun.HBM_PER_CHIP``)
where the reference's holds it against 16 GB, and the two hints that named
the TPU, rewritten for the H100.

    python -m repro_torch.launch.report [experiments/dryrun]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path


def render(dryrun_dir: str = "experiments/dryrun") -> str:
    cells = json.loads((Path(dryrun_dir) / "summary.json").read_text())
    lines = [
        "| arch | shape | mesh | compute_s | memory_s | collective_s | dominant "
        "| frac | per-dev HBM | fits 80G | mfr | what moves the dominant term |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    hints = {
        ("memory", "train"): "fuse elementwise chains (hand-written kernels) / shard replicated attention",
        ("memory", "prefill"): "flash-attention kernel (no score materialization)",
        ("memory", "decode"): "KV-cache quantization / larger per-step batch",
        ("collective", "train"): "fewer microbatches (FSDP re-gathers) / overlap",
        ("collective", "prefill"): "drop FSDP for small weights",
        ("collective", "decode"): "replicate weights, shard only KV",
        ("compute", "train"): "already compute-bound: tensor-core-aligned (wgmma) tiles",
        ("compute", "prefill"): "SWA window slicing / flash kernel",
        ("compute", "decode"): "batch more requests per step",
    }
    for c in cells:
        if c["status"] == "skipped":
            lines.append(
                f"| {c['arch']} | {c['shape']} | {c['mesh']} | — | — | — | skip | — | — | — | — | "
                f"{c['reason'][:60]} |"
            )
            continue
        if c["status"] != "ok":
            lines.append(
                f"| {c['arch']} | {c['shape']} | {c['mesh']} | ERROR {c.get('error','')[:50]} |"
            )
            continue
        r = c["roofline"]
        bound = max(r["compute_s"], r["memory_s"], r["collective_s"], 1e-12)
        frac = r["compute_s"] / bound
        hint = hints.get((r["dominant"], c["kind"]), "")
        mfr = c.get("model_flops_ratio") or 0
        lines.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} | {r['compute_s']:.4f} "
            f"| {r['memory_s']:.4f} | {r['collective_s']:.4f} | {r['dominant']} "
            f"| {frac:.3f} | {c['per_device_bytes']/2**30:.2f} GiB | {c['fits_hbm']} "
            f"| {mfr:.2f} | {hint} |"
        )
    return "\n".join(lines)


if __name__ == "__main__":
    print(render(sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun"))
