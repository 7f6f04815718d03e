"""Entry point of the single-binding scan: compile a PredTrace conjunction
into :func:`pred_filter`'s atoms and scan a columnar slab with it.

``compile_conjunction`` extracts the kernel-compatible atoms (``col <op>
int-const``) from an ``Expr`` and returns None for anything else, exactly
where the reference does: a non-comparison atom, a non-integer float, a
bool, a list or set value, an unbound ``Param``, an empty conjunction.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ...core.expr import BinOp, Col, Expr, Lit, Param, conjuncts
from .pred_filter import BLOCK_ROWS, OPS, pred_filter
from .ref import pred_filter_ref

_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "==", "!=": "!="}


def compile_conjunction(
    pred: Expr, col_order: Dict[str, int], binding: Dict[str, object]
) -> Optional[Tuple[Tuple[Tuple[int, int], ...], np.ndarray]]:
    """Returns (static atoms, thresholds) or None when not kernel-compatible."""
    atoms = []
    thresholds = []
    for a in conjuncts(pred):
        if not isinstance(a, BinOp) or a.op not in OPS:
            return None
        l, r = a.left, a.right
        op = a.op
        if not isinstance(l, Col):
            l, r, op = r, l, _FLIP[a.op]
        if not isinstance(l, Col) or l.name not in col_order:
            return None
        if isinstance(r, Lit):
            v = r.value
        elif isinstance(r, Param) and r.name in binding:
            v = binding[r.name]
        else:
            return None
        if isinstance(v, (list, tuple, np.ndarray)):
            return None  # set membership: the membership kernel's work
        if isinstance(v, (bool, np.bool_)):
            return None
        if isinstance(v, float) and not float(v).is_integer():
            return None  # int32 lanes only (fixed-point encode upstream)
        atoms.append((col_order[l.name], OPS[op]))
        thresholds.append(int(v))
    if not atoms:
        return None
    return tuple(atoms), np.asarray(thresholds, dtype=np.int32)


def scan_mask(
    cols: np.ndarray,  # [C, N] int32
    pred: Expr,
    col_order: Dict[str, int],
    binding: Dict[str, object],
    use_kernel: bool = True,
    block_rows: int = BLOCK_ROWS,
    device=None,
) -> Optional[np.ndarray]:
    """Evaluate a conjunction over a columnar slab; None if incompatible.

    Runs on ``device``: the card (``"cuda"``) when None, the plain version
    when the caller asks for ``"cpu"``.  ``use_kernel=False`` takes the
    plain version on the device instead of the kernel."""
    compiled = compile_conjunction(pred, col_order, binding)
    if compiled is None:
        return None
    atoms, thr = compiled
    dev = torch.device("cuda" if device is None else device)
    C, N = cols.shape
    pad = (-N) % block_rows
    slab = np.pad(cols, ((0, 0), (0, pad))) if pad else cols
    slab_t = torch.from_numpy(np.ascontiguousarray(slab, np.int32)).to(dev)
    thr_t = torch.from_numpy(thr).to(dev)
    if use_kernel:
        mask = pred_filter(slab_t, thr_t, atoms, block_rows=block_rows)
    else:
        mask = pred_filter_ref(slab_t, thr_t, atoms)
    return mask[:N].cpu().numpy().astype(bool)
