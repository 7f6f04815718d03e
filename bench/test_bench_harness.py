"""The harness end to end at test size on the CPU: a configuration, a cell
and a per-layer metric added as new files alone; the refusal to measure
without a card; and the check's verdict on each fault a cell can have and
on the lower-precision control."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchlib import faults, harness, manifest, program
from benchtest import BENCH, LOOSE, ROOT, add_tiny_cells, copy_benchmark

SEED = 2**31 + 77  # past 32 signed bits, as the driver's seeds are
NEW_METRIC = '''"""window_steps.train: the train steps the window finished."""


def read(rec):
    steps = [u for u in rec.window if u["kind"] == "train"]
    return len(steps) or None
'''


@pytest.fixture()
def tiny_root(tmp_path):
    root = copy_benchmark(tmp_path)
    add_tiny_cells(root, LOOSE)
    return root


def run(root, cell, trace=False, seconds=0.5, seed=SEED):
    return harness.run_cell(manifest.load(root), cell, seed, seconds, trace, "cpu",
                            time.perf_counter())


def test_cells_configs_and_metrics_are_added_by_new_files_alone(tiny_root):
    before = {p.relative_to(BENCH): p.read_bytes() for p in BENCH.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    (tiny_root / "bench" / "metrics" / "window_steps.train.py").write_text(NEW_METRIC)
    man = json.loads((tiny_root / "BENCHMARK.json").read_text())
    man["per_layer"].append({"name": "window_steps.train", "unit": "count", "better": "higher",
                             "source": "host_clock", "layer": "train step",
                             "moves": "train_tokens_per_s", "workloads": ["tiny-lm.tiny-train"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(man))
    # every file the benchmark had is there unchanged
    for rel, data in before.items():
        assert (tiny_root / "bench" / rel).read_bytes() == data, rel
    m = manifest.load(tiny_root)
    assert {"tiny-lm.tiny-train", "tiny-vlm.tiny-train"} <= set(m.cells)
    assert m.config("tiny-lm")["hidden_size"] == 64
    out = run(tiny_root, "tiny-lm.tiny-train", trace=True)
    assert out["correct"] and out["metrics"]["window_steps.train"]["value"] == out["attempted"]
    out = run(tiny_root, "tiny-vlm.tiny-train")
    assert out["correct"]
    assert set(out["metrics"]) == {"setup_s", "train_tokens_per_s"}
    assert list(out)[-1] == "check"


def test_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    # a directory that holds only the benchmark's files, as well as the repo
    for root in (ROOT, copy_benchmark(tmp_path)):
        proc = subprocess.run(
            [sys.executable, str(root / "bench" / "run.py"), "--workload",
             "qwen2-0.5b.train-4k", "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
            cwd=root, capture_output=True, text=True, timeout=300,
            env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
        assert proc.returncode != 0
        assert "{" not in proc.stdout


FAULTS = [(c, f) for c in ("tiny-lm.tiny-train", "tiny-vlm.tiny-train") for f in faults.TRAIN]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f if c == "tiny-lm.tiny-train" else f"vlm-{f}" for c, f in FAULTS])
def test_each_fault_is_not_correct(tiny_root, cell, fault):
    undo = faults.planted(program, fault)
    try:
        out = run(tiny_root, cell)
    finally:
        undo()
    assert out["correct"] is False


CELLS = list(manifest.load(ROOT).cells)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tmp_path, cell):
    """The reference in fp8 in the program's place fails the cell's own
    limits, at test size: the tiny cell of the cell's kind is held to
    them."""
    m = manifest.load(ROOT)
    kind = m.traffic(m.cells[cell].traffic)["driver"]
    root = copy_benchmark(tmp_path)
    add_tiny_cells(root, {kind: m.cell_file(cell)["limits"]})
    drv = harness.make_driver(manifest.load(root), "tiny-lm.tiny-train", SEED, "cpu")
    assert not harness.judge(drv.control(), m.cell_file(cell)["limits"])


@pytest.mark.cuda
def test_tiny_cells_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = copy_benchmark(tmp_path)
    add_tiny_cells(root, LOOSE)
    for cell in ("tiny-lm.tiny-train", "tiny-vlm.tiny-train"):
        out = harness.run_cell(manifest.load(root), cell, SEED, 0.5, True, "cuda",
                               time.perf_counter())
        assert out["correct"] and out["device"]["busy_s"] > 0
