"""Plain PyTorch version of the fused predicate scan.

``pred_filter_batch_ref`` takes no zone operands on purpose: the kernel's
in-block pruning only skips blocks its (data-derived) bounds prove empty, so
kernel-with-zones must be bit-identical to this zone-free version — that
identity is what the differential suite and ``chip_smoke.py`` assert.  The
wrapper in ``pred_filter.py`` runs :func:`_batch_bool` for tensors that lie
on the CPU; on a CUDA tensor it launches the CUDA kernel instead.
"""

from __future__ import annotations

from typing import Tuple

import torch


def search_iters(max_len: int) -> int:
    """Static iteration count for :func:`_segment_member` — enough halvings
    to collapse any segment of at most ``max_len`` elements."""
    return max(1, int(max_len).bit_length())


def _lower_bound(slab, keys, seg_lo, seg_hi, iters: int):
    """Vectorized lower bound of ``keys`` inside per-row segments of a flat
    sorted ``slab``.

    ``keys`` is ``[K, X]``; ``seg_lo``/``seg_hi`` are ``[K, 1]`` segment
    bounds (``slab[seg_lo:seg_hi]`` sorted ascending).  Runs exactly
    ``iters`` halvings; every gather is clamped to ``len(slab) - 1`` so empty
    segments and segments ending at ``len(slab)`` stay in bounds."""
    cap = slab.shape[0] - 1
    lo = torch.broadcast_to(seg_lo, keys.shape).to(torch.int32)
    hi = torch.broadcast_to(seg_hi, keys.shape).to(torch.int32)
    for _ in range(iters):
        go = lo < hi
        mid = (lo + hi) // 2
        v = slab[torch.clamp(mid, max=cap).long()]
        below = torch.logical_and(go, v < keys)
        lo = torch.where(below, mid + 1, lo)
        hi = torch.where(torch.logical_and(go, torch.logical_not(below)), mid, hi)
    return lo


def _segment_member(slab, keys, seg_lo, seg_hi, iters: int):
    """``keys[k, x] in slab[seg_lo[k]:seg_hi[k]]`` — ``[K, X]`` bool."""
    cap = slab.shape[0] - 1
    pos = _lower_bound(slab, keys, seg_lo, seg_hi, iters)
    hit = slab[torch.clamp(pos, max=cap).long()] == keys
    return torch.logical_and(pos < seg_hi, hit)


def _cmp(col, t, op: int):
    if op == 0:
        return col == t
    if op == 1:
        return col != t
    if op == 2:
        return col < t
    if op == 3:
        return col <= t
    if op == 4:
        return col > t
    if op == 5:
        return col >= t
    raise ValueError(op)


def _member_acc(acc, cols, set_cols, set_slab, set_off, set_len, iters):
    """AND per-binding ragged-set membership into a ``[K, N]`` bool acc."""
    for m, ci in enumerate(set_cols):
        seg_lo = set_off[:, m][:, None]
        seg_hi = seg_lo + set_len[:, m][:, None]
        acc = torch.logical_and(
            acc,
            _segment_member(set_slab,
                            torch.broadcast_to(cols[ci][None, :], acc.shape),
                            seg_lo, seg_hi, iters),
        )
    return acc


def _batch_bool(cols, thresholds, atoms: Tuple[Tuple[int, int], ...],
                set_cols: Tuple[int, ...] = (), set_slab=None, set_off=None,
                set_len=None, iters: int = 1):
    """cols ``[C, N]`` int32, thresholds ``[K, A]`` int32 -> ``[K, N]``
    bool masks: the conjunction of the ``A`` compares and ``M`` set atoms."""
    acc = torch.ones((thresholds.shape[0], cols.shape[1]), dtype=torch.bool,
                     device=cols.device)
    for j, (ci, op) in enumerate(atoms):
        acc = torch.logical_and(
            acc, _cmp(cols[ci][None, :], thresholds[:, j][:, None], op))
    if set_cols:
        acc = _member_acc(acc, cols, set_cols, set_slab, set_off, set_len,
                          iters)
    return acc


def pred_filter_batch_ref(cols, thresholds, atoms: Tuple[Tuple[int, int], ...],
                          set_cols: Tuple[int, ...] = (), set_slab=None,
                          set_off=None, set_len=None, iters: int = 1):
    """Batched version with the reference kernel's int32 ``[K, N]`` output."""
    return _batch_bool(cols, thresholds, atoms, set_cols, set_slab, set_off,
                       set_len, iters).to(torch.int32)
