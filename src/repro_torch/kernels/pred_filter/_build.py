"""Build and load the CUDA kernel of this package.

The source ``csrc/pred_filter.cu`` has a plain C launcher, so it compiles in
seconds with ``nvcc`` into a shared library that ``ctypes`` loads — no
PyTorch headers.  The library is built at first use into
``build/repro_torch/<source sha>/`` under the repository root (listed in
``.gitignore``), so an edited source never loads a stale binary.  Nothing
here runs at import time: the CPU-only test host imports this module without
``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).resolve().parent / "csrc" / "pred_filter.cu"
_REPO = Path(__file__).resolve().parents[4]
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


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
    """Where the library for the current source lives (built or not)."""
    sha = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _REPO / "build" / "repro_torch" / sha / "libpred_filter.so"


def build() -> Path:
    """Compile the source for ``sm_90a`` unless the library for this exact
    source already exists; returns its path.  Raises on any build failure.
    The output is written to a temporary name and renamed into place, so
    concurrent builders never load a half-written file."""
    out = _library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", tmp, str(_SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with the launcher's
    argument and return types declared."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            fn = lib.pred_filter_batch_launch
            fn.argtypes = [p, i64, i32,             # cols, n, block_rows
                           p, i32, i32, i32, p,     # thr, k, a, m, prog
                           p, p,                    # blk_lo, blk_hi
                           p, i32,                  # slab, s
                           p, p, i32,               # set_off, set_len, iters
                           p, p]                    # out, stream
            fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB
