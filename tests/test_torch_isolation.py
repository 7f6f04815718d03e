"""``repro_torch`` stands alone: every module imports with ``jax`` and the
reference package ``repro`` made unimportable."""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

_CHILD = textwrap.dedent("""
    import importlib, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "repro")

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"repro_torch must not import {name}")
            return None

    sys.meta_path.insert(0, Block())
    import repro_torch

    names = ["repro_torch"]
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(m.name)
    for name in names:
        importlib.import_module(name)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print(len(names))
""")


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run([sys.executable, "-c", _CHILD], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    # the package, its subpackages and every module of the slice
    assert int(proc.stdout.strip()) >= 20
