"""Build and load the CUDA kernels of the port, all into one library.

Every ``kernels/*/csrc/*.cu`` has a plain C launcher, so it compiles in
seconds with ``nvcc`` — no PyTorch headers.  Each source compiles to an
object in its own ``nvcc`` process, all started together, so the build takes
as long as its slowest source; one more ``nvcc`` links the objects into
``libkernels.so``, which ``ctypes`` loads.  The library is built at first use
into ``build/repro_torch/<sha of all sources, headers and flags>/`` under the
repository root (listed in ``.gitignore``), so an edited source never loads
a stale binary.  Beside it, ``ptxas.txt`` keeps what ``ptxas -v`` printed
for each kernel (registers, spills, shared memory; :func:`resources` reads
it), and :func:`sass_counts` counts instructions in the library's SASS.
Each wrapper declares its own launcher's argument types through
:func:`launcher`.  Nothing here runs at import time: the CPU-only test host
imports this module without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional

_KERNELS = Path(__file__).resolve().parent
_REPO = _KERNELS.parents[2]
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")
_COMPILE_FLAGS = ("-Xptxas", "-v")  # each kernel's resources, kept in ptxas.txt
PTXAS_LOG = "ptxas.txt"

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    """Every CUDA source of the port, in a fixed order."""
    return sorted(_KERNELS.glob("*/csrc/*.cu"))


def _tool(name: str) -> Optional[str]:
    """A CUDA toolkit program: ``$CUDA_HOME/bin/<name>`` as PyTorch locates
    the toolkit, else ``name`` on ``PATH``; None when there is none."""
    from torch.utils.cpp_extension import CUDA_HOME

    cands = []
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", name))
    found = shutil.which(name)
    if found:
        cands.append(found)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def _nvcc() -> str:
    """The CUDA compiler; raises when there is none."""
    nvcc = _tool("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch need "
                           "the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")
    return nvcc


def _library_path() -> Path:
    """Where the library for the current sources, the headers they
    include (``*/csrc/*.cuh``) and the flags lives, built or not."""
    h = hashlib.sha256(" ".join(ARCH_FLAGS + _FLAGS + _COMPILE_FLAGS).encode())
    for src in sources() + sorted(_KERNELS.glob("*/csrc/*.cuh")):
        h.update(str(src.relative_to(_KERNELS)).encode() + b"\0")
        h.update(src.read_bytes())
    return _REPO / "build" / "repro_torch" / h.hexdigest()[:16] / "libkernels.so"


def _nvcc_all(cmds) -> List[str]:
    """Run the ``nvcc`` commands together and wait for all of them; raise
    with the error output of the first that failed, else return each
    one's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
    return outs


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
        outs = _nvcc_all([[nvcc, *ARCH_FLAGS, *_FLAGS, *_COMPILE_FLAGS, "-c",
                           "-o", obj, str(src)] for obj, src in zip(objs, srcs)])
        (out.parent / PTXAS_LOG).write_text("".join(
            f"# {src.relative_to(_KERNELS)}\n{text}" for src, text in zip(srcs, outs)))
        lib = os.path.join(tmp, "libkernels.so")
        _nvcc_all([[nvcc, *ARCH_FLAGS, *_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)
    return out


_BUILTIN_TYPES = {"f": "float"}  # the builtin types the kernels are instantiated with


def _template_args(text: str) -> Optional[List[str]]:
    """The arguments of a mangled template argument list that starts
    ``text`` (``ILi64EfE`` -> ``["64", "float"]``): integers, float and
    named types; None for anything else."""
    if not text.startswith("I"):
        return None
    args, i = [], 1
    while i < len(text) and text[i] != "E":
        m = re.match(r"Li(\d+)E", text[i:])
        if m:
            args.append(m.group(1))
            i += m.end()
        elif text[i] in _BUILTIN_TYPES:
            args.append(_BUILTIN_TYPES[text[i]])
            i += 1
        elif text[i].isdigit():
            m = re.match(r"\d+", text[i:])
            start = i + len(m.group(0))
            i = start + int(m.group(0))
            args.append(text[start:i])
        else:
            return None
    return args if i < len(text) and args else None


def _kernel_name(mangled: str) -> str:
    """``flash_bwd_dq_bf16<64>`` or ``flash_attention_bf16<64, float>`` for
    a mangled kernel name whose template arguments are integers or types,
    else the mangled name itself."""
    i = mangled.find("_ZN") + 3
    name = None
    while i > 2 and i < len(mangled) and mangled[i].isdigit():
        m = re.match(r"\d+", mangled[i:])
        start = i + len(m.group(0))
        i = start + int(m.group(0))
        name = mangled[start:i]
    args = _template_args(mangled[i:]) if name else None
    return f"{name}<{', '.join(args)}>" if args else mangled


def resources(text: str) -> Dict[str, dict]:
    """Each kernel's registers, stack, spill bytes and static shared
    memory from ``ptxas -v`` output, by :func:`_kernel_name`, with the
    ptxas warnings that name it (and its notes of a "Potential Performance
    Loss", such as a serialized wgmma pipeline)."""
    out: Dict[str, dict] = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )"
                      r"(\w+)", line)
        if m:
            cur = out.setdefault(_kernel_name(m.group(1)), {"warnings": []})
            continue
        if "warning" in line or "Performance Loss" in line:
            m = re.search(r"'(\w+)'", line)
            if m:
                name = _kernel_name(m.group(1))
                out.setdefault(name, {"warnings": []})["warnings"].append(line.strip())
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    return out


def sass_counts(text: str, opcodes) -> Dict[str, Dict[str, int]]:
    """How often each of ``opcodes`` (``HGMMA``, ``UTMALDG``, ...) opens an
    instruction of each function of ``cuobjdump -sass`` output, by
    :func:`_kernel_name`."""
    out: Dict[str, Dict[str, int]] = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = out.setdefault(_kernel_name(m.group(1)), dict.fromkeys(opcodes, 0))
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
        if cur is not None and m and m.group(1) in cur:
            cur[m.group(1)] += 1
    return out


def sass(lib: Path) -> Optional[str]:
    """``cuobjdump -sass`` of the built library, or None where the toolkit
    has no ``cuobjdump``."""
    tool = _tool("cuobjdump")
    if tool is None:
        return None
    return subprocess.run([tool, "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout


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
