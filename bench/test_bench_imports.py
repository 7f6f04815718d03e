"""What the benchmark may import, checked on its sources by their syntax
trees: never JAX, its libraries or the JAX package (``repro``), compared by
whole top-level name, and in the reference nothing of the port either; and
nothing the harness runs reads the JAX package's ``benchmarks/``."""

import ast

import pytest

from benchtest import BENCH

EVERYWHERE = {"jax", "jaxlib", "flax", "repro"}
IN_REFERENCE = EVERYWHERE | {"repro_torch"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_sources_are_found():
    assert BENCH / "run.py" in SOURCES and BENCH / "reference" / "decoder.py" in SOURCES


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_import(path):
    banned = IN_REFERENCE if "reference" in path.relative_to(BENCH).parts else EVERYWHERE
    assert not top_level_imports(path) & banned


def test_the_check_compares_whole_names(tmp_path):
    src = tmp_path / "x.py"
    src.write_text("import repro_torch.models\nfrom repro_torch import kernels\n"
                   "import jax.numpy as jnp\nfrom repro.core import x\n")
    got = top_level_imports(src)
    assert got == {"repro_torch", "jax", "repro"}
    assert got & EVERYWHERE == {"jax", "repro"}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_nothing_reads_the_jax_benchmarks(path):
    assert "benchmarks/" not in path.read_text() or path.name.startswith("test_bench_")
