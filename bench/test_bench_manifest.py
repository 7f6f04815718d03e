"""The manifest's rules: the committed ``BENCHMARK.json`` passes them, and
each rule refuses what it should."""

import copy
import json

import pytest

from benchlib import manifest
from benchtest import ROOT


@pytest.fixture()
def data():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_committed_manifest_is_valid():
    m = manifest.load(ROOT)
    assert list(m.cells) == ["qwen2-0.5b.train-4k", "qwen2-0.5b.train-1k"]
    assert all(c.chips == 1 for c in m.cells.values())
    assert set(m.end_to_end) == {"setup_s", "train_tokens_per_s"}
    assert m.data["command"] == ["python3", "bench/run.py"]
    assert m.data["paths"] == ["bench"]


def test_every_cell_reports_what_it_must():
    m = manifest.load(ROOT)
    for cell in m.cells:
        e2e = {x["name"] for x in m.cell_metrics(cell, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = m.cell_metrics(cell, "per_layer")
        assert layers and all(x["moves"] in e2e for x in layers)


def test_each_metric_has_its_reader_and_each_cell_its_files():
    m = manifest.load(ROOT)
    for name in m.per_layer:
        assert callable(m.reader(name).read)
    for cell in m.cells.values():
        traffic = m.traffic(cell.traffic)
        assert hasattr(m.driver(traffic["driver"]), "Driver")
        assert m.cell_file(cell.name)["limits"]
        assert m.config(cell.config)["name"] == cell.config


@pytest.mark.parametrize("name", ["a b", "a,b", "a/b", ".a", "-a", "a" * 65, "", "µs"])
def test_bad_names_are_refused(data, name):
    bad = copy.deepcopy(data)
    bad["per_layer"][0]["name"] = name
    with pytest.raises(manifest.ManifestError):
        manifest.validate(bad, ROOT)


@pytest.mark.parametrize("unit", ["tokens per s", "µs", "", "x" * 17, "a,b"])
def test_bad_units_are_refused(data, unit):
    bad = copy.deepcopy(data)
    bad["end_to_end"][1]["unit"] = unit
    with pytest.raises(manifest.ManifestError):
        manifest.validate(bad, ROOT)


@pytest.mark.parametrize("unit", ["tokens/s", "%", "ms/ktok", "s", "count"])
def test_good_units_pass(data, unit):
    ok = copy.deepcopy(data)
    ok["end_to_end"][1]["unit"] = unit
    manifest.validate(ok, ROOT)


@pytest.mark.parametrize("change", [
    lambda d: d["per_layer"][0].update(why="a key no metric may carry"),
    lambda d: d.update(extra=1),
    lambda d: d["end_to_end"][1].update(bound=0.3),
    lambda d: d["end_to_end"][1].update(bound=0.005),
    lambda d: d.update(run_seconds=52),
    lambda d: d["end_to_end"].pop(0),
    lambda d: d["workloads"][0].update(chips=2),
    lambda d: d["workloads"].append(dict(d["workloads"][0], name="again")),
    lambda d: d["per_layer"][0].update(moves="not_a_metric"),
    lambda d: d["per_layer"][0].update(layer="two\nlines"),
    lambda d: d["configs"][0].update(reduced=["hidden_size"]),
    lambda d: d["configs"][0].update(reduced=["head_dim"]),
    lambda d: d["configs"][0].update(why="x" * 201),
    lambda d: d["per_layer"].append(dict(d["per_layer"][0], name="no_reader_file")),
    lambda d: d.update(command=["python3", "/abs/run.py"]),
    lambda d: d.update(paths=["../outside"]),
], ids=["metric-why", "top-key", "bound-high", "bound-low", "run-seconds", "no-setup",
        "chips", "pair-twice", "moves", "layer-lines", "reduced-width", "reduced-dim",
        "why-long", "no-reader", "abs-command", "path-out"])
def test_rules_refuse(data, change):
    bad = copy.deepcopy(data)
    change(bad)
    with pytest.raises(manifest.ManifestError):
        manifest.validate(bad, ROOT)
