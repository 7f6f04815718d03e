"""Entry point of the membership probe: any sizes, numpy in and out."""

from __future__ import annotations

import numpy as np
import torch

from .membership import launch_sorted
from .ref import membership_ref

SENTINEL = np.int32(-2_147_483_648)


def probe(values: np.ndarray, vset: np.ndarray, use_kernel: bool = True,
          device=None) -> np.ndarray:
    """Boolean membership mask of ``values`` in ``vset``, equal to
    ``np.isin``.  Runs on ``device``: the card (``"cuda"``) when None, the
    plain version when the caller asks for ``"cpu"``; ``use_kernel=False``
    takes the plain version on the device.  The kernel runs at every set
    size, on ``np.unique``'s sorted set and the values as they are: nothing
    is padded, so ``SENTINEL`` is an ordinary value."""
    values = np.asarray(values, dtype=np.int32)
    vset = np.unique(np.asarray(vset, dtype=np.int32))
    if len(vset) == 0 or len(values) == 0:
        return np.zeros(len(values), dtype=bool)
    dev = torch.device("cuda" if device is None else device)
    vals = torch.from_numpy(values).to(dev)
    keys = torch.from_numpy(vset).to(dev)
    if use_kernel and dev.type != "cpu":
        mask = launch_sorted(vals, keys)
    else:
        mask = membership_ref(vals, keys)
    return mask.cpu().numpy().astype(bool)
