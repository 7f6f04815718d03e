from .pred_filter import (
    BLOCK_ROWS,
    LAUNCHES,
    OPS,
    block_bounds,
    pack_program,
    pred_filter,
    pred_filter_batch,
    reset_launches,
)
from .ref import pred_filter_batch_ref, pred_filter_ref, search_iters
from .ops import compile_conjunction, scan_mask

__all__ = ["BLOCK_ROWS", "LAUNCHES", "OPS", "block_bounds",
           "compile_conjunction", "pack_program", "pred_filter",
           "pred_filter_batch", "pred_filter_batch_ref", "pred_filter_ref",
           "reset_launches", "scan_mask", "search_iters"]
