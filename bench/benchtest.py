"""Helpers of the benchmark's tests: where the benchmark lies, the harness
and the port on the path, and a copy of the benchmark with tiny cells that
the CPU runs through the whole harness.

The benchmark keeps no ``conftest.py``: the repository's own tests import
their ``conftest`` by that name, which a second one would shadow.  The
``cuda`` marker is the one the repository's ``tests/conftest.py``
registers."""

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for _p in (str(BENCH), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# a qwen2-like and a phi-3-vision-like configuration at test size, with the
# published keys the harness reads
TINY_CONFIGS = {
    "tiny-lm": {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
                "num_attention_heads": 4, "num_key_value_heads": 2, "vocab_size": 256,
                "rms_norm_eps": 1e-6, "rope_theta": 1e6, "torch_dtype": "bfloat16",
                "qkv_bias": True, "reference": "decoder"},
    "tiny-vlm": {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
                 "num_attention_heads": 4, "num_key_value_heads": 4, "vocab_size": 200,
                 "rms_norm_eps": 1e-5, "rope_theta": 1e4, "torch_dtype": "bfloat16",
                 "qkv_bias": False, "n_patches": 8, "reference": "decoder"},
}
TINY_TRAFFIC = {
    "tiny-train": {"driver": "train", "sequences": 4, "seq_len": 64, "microbatches": 2,
                   "remat": True, "checked_steps": 3, "profiled_steps": 1,
                   "optimizer": {"lr": 3e-4, "beta1": 0.9, "beta2": 0.95, "eps": 1e-8,
                                 "weight_decay": 0.1, "clip_norm": 1.0, "warmup_steps": 2,
                                 "total_steps": 100, "min_lr_ratio": 0.1}},
}
TINY_CELLS = {"tiny-lm.tiny-train": ("tiny-lm", "tiny-train"),
              "tiny-vlm.tiny-train": ("tiny-vlm", "tiny-train")}
LIKE = {"train": "qwen2-0.5b.train-4k"}


def copy_benchmark(dest: Path) -> Path:
    """The benchmark's files (``BENCHMARK.json`` and ``bench/``) copied to
    ``dest``."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(BENCH, dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    return dest


def add_tiny_cells(root: Path, limits: dict) -> None:
    """Tiny configurations, traffic and cells added to the copy at ``root``
    as new files and new manifest entries alone; each cell gets ``limits``
    of its driver's kind."""
    bench = root / "bench"
    man = json.loads((root / "BENCHMARK.json").read_text())
    for name, conf in TINY_CONFIGS.items():
        (bench / "configs" / f"{name}.json").write_text(json.dumps(dict(conf, name=name)))
        man["configs"].append({"name": name, "source": "https://example.org/tiny",
                               "file": f"bench/configs/{name}.json", "reduced": [],
                               "why": "test size"})
    for name, tr in TINY_TRAFFIC.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(tr))
    for cell, (conf, traffic) in TINY_CELLS.items():
        kind = TINY_TRAFFIC[traffic]["driver"]
        (bench / "workloads" / f"{cell}.json").write_text(json.dumps({"limits": limits[kind]}))
        man["workloads"].append({"name": cell, "config": conf, "traffic": traffic,
                                 "chips": 1, "why": "test size"})
        like = LIKE[kind]  # the metrics of the benchmark's cell of this kind
        for m in man["end_to_end"] + man["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))


LOOSE = {"train": {"loss": 0.05, "grad_norm": 0.05, "grad_leaf": 0.05, "change_leaf": 0.05}}
