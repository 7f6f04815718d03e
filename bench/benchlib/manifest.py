"""``BENCHMARK.json`` and the files it names, read and checked.

The manifest lists configurations, cells and metrics; everything that
belongs to one of them sits in a file of its own under the benchmark's
directory, found by its name:

* ``configs/<config>.json``: the configuration as it is run (the file the
  manifest's ``file`` names), with the reference module it is held to;
* ``traffic/<traffic>.json``: the traffic mix, a dict of parameters with
  the ``driver`` that reads it;
* ``drivers/<driver>.py``: one general generator per kind of traffic;
* ``workloads/<cell>.json``: the cell's correctness limits;
* ``metrics/<metric>.py``: one reader per per-layer metric.

So a configuration, a cell or a per-layer metric is added with new files
and new manifest entries alone.  :func:`load` refuses a manifest that
breaks the benchmark's rules on names, units, keys and bounds.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
E2E_SOURCES = {"host_clock", "device_trace"}
SOURCES = E2E_SOURCES | {"program_span", "program_counter"}
# keys that name a width, which no configuration may cut
WIDTH_WORDS = ("hidden_size", "intermediate_size", "latent", "state_size",
               "proj", "head_size", "expan", "experts_per_tok", "top_k",
               "d_model", "d_ff")


class ManifestError(ValueError):
    pass


def _fail(msg: str) -> None:
    raise ManifestError(msg)


def _name(value, what: str) -> str:
    if not isinstance(value, str) or not NAME.fullmatch(value):
        _fail(f"{what} {value!r} is not a name: 1-64 of letters, digits, "
              f"'_', '.', '-', not starting with '.' or '-'")
    return value


def _line(value, what: str) -> str:
    if (not isinstance(value, str) or not 1 <= len(value) <= 200
            or "\n" in value or "\t" in value or "\r" in value):
        _fail(f"{what} must be 1-200 characters on one line with no tab")
    return value


def _keys(entry, allowed: set, optional: set, what: str) -> None:
    if not isinstance(entry, dict):
        _fail(f"{what} must be an object")
    missing = allowed - set(entry)
    extra = set(entry) - allowed - optional
    if missing or extra:
        _fail(f"{what}: missing {sorted(missing)}, not allowed {sorted(extra)}")


def _is_width(key: str) -> bool:
    k = key.lower()
    return k.endswith(("_dim", "_rank")) or any(w in k for w in WIDTH_WORDS)


@dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int
    why: str


class Manifest:
    """A checked ``BENCHMARK.json`` and the directory that holds its files
    (``bench``, the first of ``paths``)."""

    def __init__(self, data: dict, root: Path):
        self.data = data
        self.root = Path(root)
        self.bench = self.root / data["paths"][0]
        self.configs = {c["name"]: c for c in data["configs"]}
        self.cells = {w["name"]: Cell(**w) for w in data["workloads"]}
        self.end_to_end = {m["name"]: m for m in data["end_to_end"]}
        self.per_layer = {m["name"]: m for m in data["per_layer"]}

    # ---- the files each entry names -------------------------------------- #

    def config(self, name: str) -> dict:
        return _json(self.root / self.configs[name]["file"])

    def traffic(self, name: str) -> dict:
        return _json(self.bench / "traffic" / f"{name}.json")

    def cell_file(self, name: str) -> dict:
        return _json(self.bench / "workloads" / f"{name}.json")

    def driver(self, kind: str) -> ModuleType:
        return load_module(self.bench / "drivers" / f"{kind}.py", f"bench_driver_{kind}")

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.bench / "metrics" / f"{metric}.py",
                           "bench_metric_" + metric.replace(".", "_").replace("-", "_"))

    def reference(self, name: str) -> ModuleType:
        return load_module(self.bench / "reference" / f"{name}.py",
                           f"bench_reference_{name}")

    # ---- which metrics a cell reports ------------------------------------ #

    def cell_metrics(self, cell: str, table: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports:
        those whose ``workloads`` list it, or that have no such list."""
        entries = self.data[table]
        return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """The Python file ``path`` as a module (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ManifestError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(root: Optional[Path] = None) -> Manifest:
    """``<root>/BENCHMARK.json`` (the repository root by default), checked
    against the benchmark's rules and against the files it names."""
    root = ROOT if root is None else Path(root)
    path = root / "BENCHMARK.json"
    if path.stat().st_size > 64 * 1024:
        _fail("BENCHMARK.json is over 64 KiB")
    data = _json(path)
    validate(data, root)
    return Manifest(data, root)


def validate(data: dict, root: Path) -> None:
    _keys(data, TOP_KEYS, set(), "BENCHMARK.json")
    _check_command(data)
    _check_configs(data, root)
    _check_cells(data, root)
    _check_metrics(data, root)


def _check_command(data: dict) -> None:
    paths, cmd = data["paths"], data["command"]
    if not isinstance(paths, list) or not 1 <= len(paths) <= 16:
        _fail("paths must list 1-16 directories")
    for p in paths:
        if (not isinstance(p, str) or not PATH.fullmatch(p) or p.startswith("/")
                or ".." in p.split("/")):
            _fail(f"path {p!r} is not a relative path of letters, digits, _ . - /")
    if (not isinstance(cmd, list) or not 1 <= len(cmd) <= 32
            or not all(isinstance(w, str) for w in cmd)):
        _fail("command must be a list of 1-32 strings")
    for w in cmd:
        _line(w, "a word of command")
        if w.startswith("/") or ".." in w.split("/"):
            _fail(f"command word {w!r} leads outside the checkout")
    rs = data["run_seconds"]
    if not isinstance(rs, int) or isinstance(rs, bool) or not 1 <= rs <= 51:
        _fail("run_seconds must be a whole number from 1 to 51")


def _under_paths(rel: str, data: dict) -> bool:
    return any(rel.startswith(p.rstrip("/") + "/") for p in data["paths"])


def _check_configs(data: dict, root: Path) -> None:
    configs = data["configs"]
    if not isinstance(configs, list) or not 1 <= len(configs) <= 24:
        _fail("configs must list 1-24 configurations")
    files = set()
    for c in configs:
        _keys(c, CONFIG_KEYS, set(), f"config {c.get('name')!r}")
        _name(c["name"], "config name")
        _line(c["source"], f"source of {c['name']}")
        _line(c["why"], f"why of {c['name']}")
        if not _under_paths(c["file"], data) or not (root / c["file"]).is_file():
            _fail(f"config file {c['file']!r} is not a file under paths")
        if c["file"] in files:
            _fail(f"config file {c['file']!r} is named twice")
        files.add(c["file"])
        red = c["reduced"]
        if not isinstance(red, list) or len(red) > 16:
            _fail(f"reduced of {c['name']} must list at most 16 keys")
        for k in red:
            _name(k, f"reduced key of {c['name']}")
            if _is_width(k):
                _fail(f"reduced of {c['name']} names a width: {k}")
        body = _json(root / c["file"])
        for k in red:
            if k not in body:
                _fail(f"{c['file']} does not hold the reduced key {k}")
    _unique([c["name"] for c in configs], "config")


def _check_cells(data: dict, root: Path) -> None:
    cells = data["workloads"]
    if not isinstance(cells, list) or not 1 <= len(cells) <= 24:
        _fail("workloads must list 1-24 cells")
    configs = {c["name"] for c in data["configs"]}
    bench = root / data["paths"][0]
    pairs = set()
    for w in cells:
        _keys(w, CELL_KEYS, set(), f"cell {w.get('name')!r}")
        _name(w["name"], "cell name")
        _name(w["config"], "cell config")
        _name(w["traffic"], "cell traffic")
        _line(w["why"], f"why of {w['name']}")
        if w["config"] not in configs:
            _fail(f"cell {w['name']} names an unknown config {w['config']}")
        if w["chips"] not in (1, 4) or isinstance(w["chips"], bool):
            _fail(f"cell {w['name']}: chips must be 1 or 4")
        if (w["config"], w["traffic"]) in pairs:
            _fail(f"config {w['config']} with traffic {w['traffic']} appears twice")
        pairs.add((w["config"], w["traffic"]))
        traffic = bench / "traffic" / f"{w['traffic']}.json"
        if not traffic.is_file():
            _fail(f"cell {w['name']}: no traffic file {traffic.name}")
        driver = _json(traffic).get("driver")
        if not isinstance(driver, str) or not (bench / "drivers" / f"{driver}.py").is_file():
            _fail(f"traffic {w['traffic']}: no driver {driver!r}")
        if not (bench / "workloads" / f"{w['name']}.json").is_file():
            _fail(f"cell {w['name']}: no file workloads/{w['name']}.json")
    _unique([w["name"] for w in cells], "cell")
    used = {w["config"] for w in cells}
    if configs - used:
        _fail(f"configs used by no cell: {sorted(configs - used)}")
    four = sum(w["chips"] == 4 for w in cells)
    if four > max(1, len(cells) // 4):
        _fail(f"{four} cells ask for 4 chips")


def _check_metric(m: dict, table: str, data: dict) -> None:
    _name(m["name"], f"{table} metric name")
    if not isinstance(m["unit"], str) or not UNIT.fullmatch(m["unit"]):
        _fail(f"unit {m['unit']!r} of {m['name']}: 1-16 of letters, digits, _ / % . -")
    if m["better"] not in ("lower", "higher"):
        _fail(f"better of {m['name']} must be lower or higher")
    cells = {w["name"] for w in data["workloads"]}
    if "workloads" in m:
        ws = m["workloads"]
        if not isinstance(ws, list) or not ws or not set(ws) <= cells:
            _fail(f"workloads of {m['name']} must list known cells")


def _check_metrics(data: dict, root: Path) -> None:
    e2e, layer = data["end_to_end"], data["per_layer"]
    if not isinstance(e2e, list) or not 1 <= len(e2e) <= 16:
        _fail("end_to_end must list 1-16 metrics")
    if not isinstance(layer, list) or not 1 <= len(layer) <= 128:
        _fail("per_layer must list 1-128 metrics")
    for m in e2e:
        _keys(m, E2E_KEYS, {"workloads"}, f"end_to_end {m.get('name')!r}")
        _check_metric(m, "end_to_end", data)
        if m["source"] not in E2E_SOURCES:
            _fail(f"source of {m['name']} must be host_clock or device_trace")
        b = m["bound"]
        if not isinstance(b, (int, float)) or isinstance(b, bool) or not 0.01 <= b <= 0.25:
            _fail(f"bound of {m['name']} must lie in [0.01, 0.25]")
    names = {m["name"] for m in e2e}
    if "setup_s" not in names:
        _fail("end_to_end must hold setup_s")
    bench = root / data["paths"][0]
    for m in layer:
        _keys(m, LAYER_KEYS, {"workloads"}, f"per_layer {m.get('name')!r}")
        _check_metric(m, "per_layer", data)
        if m["source"] not in SOURCES:
            _fail(f"source of {m['name']} is not one of {sorted(SOURCES)}")
        _line(m["layer"], f"layer of {m['name']}")
        if m["moves"] not in names:
            _fail(f"{m['name']} moves {m['moves']}, not an end-to-end metric")
        if not (bench / "metrics" / f"{m['name']}.py").is_file():
            _fail(f"per-layer metric {m['name']} has no reader metrics/{m['name']}.py")
    _unique([m["name"] for m in e2e + layer], "metric")
    for w in data["workloads"]:
        cell = w["name"]
        reports = [m for m in e2e if "workloads" not in m or cell in m["workloads"]]
        if not any(m["name"] == "setup_s" for m in reports) or len(reports) < 2:
            _fail(f"cell {cell} must report setup_s and another end-to-end metric")
        layers = [m for m in layer if "workloads" not in m or cell in m["workloads"]]
        if not layers:
            _fail(f"cell {cell} reports no per-layer metric")
        for m in layers:
            moved = next(e for e in e2e if e["name"] == m["moves"])
            if "workloads" in moved and cell not in moved["workloads"]:
                _fail(f"{m['name']} is read in {cell}, which does not report "
                      f"{m['moves']}")


def _unique(names: List[str], what: str) -> None:
    seen: Dict[str, int] = {}
    for n in names:
        seen[n] = seen.get(n, 0) + 1
    dup = sorted(n for n, k in seen.items() if k > 1)
    if dup:
        _fail(f"{what} names given twice: {dup}")
