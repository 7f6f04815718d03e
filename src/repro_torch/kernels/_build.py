"""Build and load the CUDA kernels of the port, all into one library.

Every ``kernels/*/csrc/*.cu`` has a plain C launcher, so it compiles in
seconds with ``nvcc`` — no PyTorch headers.  Each source compiles to an
object in its own ``nvcc`` process, all started together, so the build takes
as long as its slowest source; one more ``nvcc`` links the objects into
``libkernels.so``, which ``ctypes`` loads.  The library is built at first use
into ``build/repro_torch/<sha of all sources and headers>/`` under the
repository root (listed in ``.gitignore``), so an edited source never loads
a stale binary.
Each wrapper declares its own launcher's argument types through
:func:`launcher`.  Nothing here runs at import time: the CPU-only test host
imports this module without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

_KERNELS = Path(__file__).resolve().parent
_REPO = _KERNELS.parents[2]
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    """Every CUDA source of the port, in a fixed order."""
    return sorted(_KERNELS.glob("*/csrc/*.cu"))


def _nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` as PyTorch locates the
    toolkit, else ``nvcc`` on ``PATH``.  Raises when there is none."""
    from torch.utils.cpp_extension import CUDA_HOME

    cands = []
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch need "
                       "the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def _library_path() -> Path:
    """Where the library for the current sources and the headers they
    include (``*/csrc/*.cuh``) lives, built or not."""
    h = hashlib.sha256()
    for src in sources() + sorted(_KERNELS.glob("*/csrc/*.cuh")):
        h.update(str(src.relative_to(_KERNELS)).encode() + b"\0")
        h.update(src.read_bytes())
    return _REPO / "build" / "repro_torch" / h.hexdigest()[:16] / "libkernels.so"


def _nvcc_all(cmds) -> None:
    """Run the ``nvcc`` commands together and wait for all of them; raise
    with the error output of the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{out}")


def build() -> Path:
    """Compile every source for ``sm_90a`` unless the library for these
    exact sources already exists; returns its path.  Raises on any build
    failure.  Objects go to a temporary directory and the library is renamed
    into place, so concurrent builders never load a half-written file."""
    out = _library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        srcs = sources()
        objs = [os.path.join(tmp, f"{s.parent.parent.name}_{s.stem}.o")
                for s in srcs]
        _nvcc_all([[nvcc, *ARCH_FLAGS, *_FLAGS, "-c", "-o", obj, str(src)]
                   for obj, src in zip(objs, srcs)])
        lib = os.path.join(tmp, "libkernels.so")
        _nvcc_all([[nvcc, *ARCH_FLAGS, *_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = ctypes.CDLL(str(build()))
        return _LIB


@functools.lru_cache(maxsize=None)
def launcher(name: str, *argtypes):
    """The library's plain C launcher ``name`` with the argument types its
    wrapper declares (pointers and the stream are ``c_void_p``); it returns
    a ``cudaError_t`` as an ``int``."""
    fn = getattr(load(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
