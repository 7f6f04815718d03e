"""Fused conjunctive-predicate scan: the wrapper around the CUDA kernel.

A pushed-down predicate is a conjunction of atoms ``col <op> const``; the
scan evaluates all atoms of K bindings in one pass over an int32 column slab
``[C, N]`` and returns ``[K, N]`` bool masks.  Zone pruning is fused in:
per-block ``[lo, hi]`` bounds (``[A(+M), G]`` operands, one row per atom,
built once per slab with :func:`block_bounds`) are checked against every
binding's thresholds before a block's columns are read, and a block no
binding can match only writes zeros.  Membership atoms (``col IN set``) ride
the same launch: sorted per-binding key sets concatenated into one flat
``set_slab``, addressed by ``[K, M]`` offset/length operands, searched per
row by a fixed-iteration lower bound.

Dispatch is by the device of the tensors: CPU tensors take the plain PyTorch
version (``ref.py``); CUDA tensors launch the hand-written kernel
(``csrc/pred_filter.cu``, built for ``sm_90a`` at first use) or raise.  The
bounds must genuinely bound each block's values, so pruning is conservative
and the kernel is bit-identical to the zone-free plain version.

Atom ops: 0:== 1:!= 2:< 3:<= 4:> 5:>=
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .ref import _batch_bool

BLOCK_ROWS = 1024

OPS = {"==": 0, "!=": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}

# kernel launches per variant: "cmp" (comparison atoms only, the TPU
# kernel's _kernel_batch) and "sets" (with IN atoms, _kernel_batch_sets).
# Bumped where the kernel is launched and nowhere else.
LAUNCHES: Dict[str, int] = {"cmp": 0, "sets": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pack_program(atoms: Tuple[Tuple[int, int], ...],
                 set_cols: Tuple[int, ...] = ()) -> np.ndarray:
    """The kernel's atom program as one ``[2A + M]`` int32 array: atom
    columns, atom ops, set columns."""
    return np.asarray([c for c, _ in atoms] + [o for _, o in atoms]
                      + list(set_cols), dtype=np.int32)


def pred_filter_batch(
    cols: torch.Tensor,  # [C, N] int32 columnar slab, N % block_rows == 0
    thresholds: torch.Tensor,  # [K, A] int32 — K bindings x A atoms
    atoms: Tuple[Tuple[int, int], ...],  # (col_idx, op_code) per atom
    blk_lo: torch.Tensor,  # [A(+M), G] int32 per-(atom, block) lower bounds
    blk_hi: torch.Tensor,  # [A(+M), G] int32 per-(atom, block) upper bounds
    block_rows: int = BLOCK_ROWS,
    set_cols: Tuple[int, ...] = (),  # col idx per membership atom
    set_slab: torch.Tensor = None,  # [S] int32 concatenated sorted sets
    set_off: torch.Tensor = None,  # [K, M] int32 offsets into set_slab, >= 0
    set_len: torch.Tensor = None,  # [K, M] int32 lengths, off + len <= S
    iters: int = 1,  # search depth: search_iters(max set len)
    program: torch.Tensor = None,  # device copy of pack_program(atoms, set_cols)
) -> torch.Tensor:  # [K, N] bool masks
    """``program`` lets a caller ride the atom program in its own operand
    upload; the CUDA path packs and uploads it when it is None."""
    C, N = cols.shape
    K, A = thresholds.shape
    M = len(set_cols)
    if N % block_rows:
        raise ValueError(f"pad N={N} to a multiple of {block_rows}")
    if A != len(atoms) or tuple(blk_lo.shape) != (A + M, N // block_rows) \
            or tuple(blk_hi.shape) != tuple(blk_lo.shape):
        raise ValueError("atoms / zone bounds do not match the thresholds")
    if M and (set_slab is None or tuple(set_off.shape) != (K, M)
              or tuple(set_len.shape) != (K, M)):
        raise ValueError("set atoms need set_slab and [K, M] set_off/set_len")
    if not all(0 <= int(c) < C and 0 <= int(o) < len(OPS) for c, o in atoms) \
            or not all(0 <= int(c) < C for c in set_cols):
        raise ValueError("atom / set columns must index the slab, ops 0-5")
    if cols.device.type == "cpu":
        return _batch_bool(cols, thresholds, atoms, tuple(set_cols), set_slab,
                           set_off, set_len, iters)
    if cols.device.type != "cuda":
        raise ValueError(f"pred_filter_batch: unsupported device {cols.device}")
    return _launch_cuda(cols, thresholds, atoms, blk_lo, blk_hi, block_rows,
                        tuple(set_cols), set_slab, set_off, set_len, iters,
                        program)


def _check(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 tensor on {device}")


def _launch_cuda(cols, thr, atoms, blk_lo, blk_hi, block_rows, set_cols,
                 set_slab, set_off, set_len, iters, program) -> torch.Tensor:
    from ._build import load

    dev = cols.device
    C, N = cols.shape
    K, A = thr.shape
    M = len(set_cols)
    if program is None:
        program = torch.from_numpy(pack_program(atoms, set_cols)).to(dev)
    if program.numel() != 2 * A + M:
        raise ValueError(f"program must hold {2 * A + M} int32 values")
    named = [("cols", cols), ("thresholds", thr), ("blk_lo", blk_lo),
             ("blk_hi", blk_hi), ("program", program)]
    if M:
        named += [("set_slab", set_slab), ("set_off", set_off),
                  ("set_len", set_len)]
    for name, t in named:
        _check(name, t, dev)
    out = torch.empty((K, N), dtype=torch.bool, device=dev)
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pred_filter_batch_launch(
            cols.data_ptr(), N, block_rows, thr.data_ptr(), K, A, M,
            program.data_ptr(), blk_lo.data_ptr(), blk_hi.data_ptr(),
            set_slab.data_ptr() if M else None,
            int(set_slab.numel()) if M else 0,
            set_off.data_ptr() if M else None,
            set_len.data_ptr() if M else None, int(iters),
            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"pred_filter_batch kernel launch failed: "
                           f"cudaError {rc}")
    LAUNCHES["sets" if M else "cmp"] += 1
    return out


def block_bounds(slab: np.ndarray, block_rows: int,
                 atom_cols: Tuple[int, ...]) -> Tuple[np.ndarray, np.ndarray]:
    """Per-(atom, block) ``[lo, hi]`` bounds of an ``[C, N]`` int32 slab —
    the zone operands :func:`pred_filter_batch` prunes against.  One
    ``reduceat`` pass per referenced column, computed once per cached slab."""
    C, N = slab.shape
    if N % block_rows:
        raise ValueError(f"pad N={N} to a multiple of {block_rows}")
    starts = np.arange(0, N, block_rows)
    lo = np.empty((len(atom_cols), len(starts)), np.int32)
    hi = np.empty_like(lo)
    per_col = {}
    for j, ci in enumerate(atom_cols):
        if ci not in per_col:
            per_col[ci] = (
                np.minimum.reduceat(slab[ci], starts),
                np.maximum.reduceat(slab[ci], starts),
            )
        lo[j], hi[j] = per_col[ci]
    return lo, hi
