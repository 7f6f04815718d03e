"""Set-membership probe (``col IN V-set``): the wrapper around the CUDA
kernel ``csrc/membership.cu``.

The kernel runs a lower-bound binary search per value over the set sorted
ascending; :func:`membership` sorts the set on the device before the launch.
That sort is set-up, not the membership function, and it lets a caller pass
any set: unsorted, duplicated, of any length.  ``probe`` holds
``np.unique``'s sorted set already and launches :func:`launch_sorted`
without it.  Each CTA stages the set in shared memory when it has at most
``SMEM_KEYS`` keys, else a fence index, the last key of every aligned
``step``-key range (:func:`fence_plan`), and searches there first.
Dispatch is by the device of the tensors: CPU tensors take the plain
PyTorch version (``ref.py``, ``isin``); CUDA tensors launch the kernel or
raise, at every set size.
"""

from __future__ import annotations

from ctypes import c_int64, c_void_p
from typing import Dict, Tuple

import torch

from .ref import membership_ref

BLOCK_ROWS = 1024
# the TPU kernel's set tile; the CUDA kernel takes a set of any length, so
# nothing pads to it
SET_TILE = 256

# the kernel's staging limits (kSmemKeys, kFenceKeys and kBlockKeys in
# csrc/membership.cu): a set of at most SMEM_KEYS keys is staged whole, a
# larger one as at most FENCE_KEYS fences, whose ranges the search narrows
# to aligned blocks of BLOCK_KEYS keys
SMEM_KEYS = 57_344
FENCE_KEYS = 16_384
BLOCK_KEYS = 8

# kernel launches, bumped where the kernel is launched and nowhere else
LAUNCHES: Dict[str, int] = {"membership": 0}

# membership_launch's C signature (csrc/membership.cu): values, n, sorted
# set, m, out, stream
_ARGS = (c_void_p, c_int64, c_void_p, c_int64, c_void_p, c_void_p)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fence_plan(m: int) -> Tuple[int, int]:
    """``(staged, step)`` of the kernel for a set of ``m`` keys: ``step`` 1
    stages the set whole; else ``step`` is a power of two, at least
    ``BLOCK_KEYS``, and the last key of each of the ``staged`` aligned
    ranges of ``step`` keys is staged."""
    if m <= SMEM_KEYS:
        return m, 1
    step = BLOCK_KEYS
    while step * FENCE_KEYS < m:
        step *= 2
    return -(-m // step), step


def membership(
    values: torch.Tensor,  # [N] int32, N % block_rows == 0
    vset: torch.Tensor,  # [M] int32, any order, duplicates allowed
    block_rows: int = BLOCK_ROWS,
) -> torch.Tensor:  # [N] int32 0/1
    """``values[i] in vset`` as int32.  The CUDA kernel needs no row blocks;
    ``block_rows`` keeps the reference's contract (``N`` a multiple of
    it)."""
    if values.dim() != 1 or vset.dim() != 1:
        raise ValueError("values and vset must be 1-D")
    if values.shape[0] % block_rows:
        raise ValueError(f"pad N={values.shape[0]} to a multiple of {block_rows}")
    if values.device != vset.device:
        raise ValueError("values and vset must lie on one device")
    if values.device.type == "cpu":
        return membership_ref(values, vset)
    if values.device.type != "cuda":
        raise ValueError(f"membership: unsupported device {values.device}")
    return launch_sorted(values, torch.sort(vset).values)


def launch_sorted(values: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors, ``keys`` sorted ascending; ``values`` of
    any length.  Raises on any other device."""
    from .._build import launcher

    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"membership kernel: unsupported device {dev}")
    for name, t in (("values", values), ("set", keys)):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on {dev}")
    if keys.numel() > SMEM_KEYS and keys.data_ptr() % 16:
        keys = keys.clone()  # the kernel reads a large set 16 bytes at a time
    out = torch.empty(values.shape[0], dtype=torch.int32, device=dev)
    launch = launcher("membership_launch", *_ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(values.data_ptr(), values.shape[0],
                    keys.data_ptr() if keys.numel() else None, keys.numel(),
                    out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"membership kernel launch failed: cudaError {rc}")
    LAUNCHES["membership"] += 1
    return out
