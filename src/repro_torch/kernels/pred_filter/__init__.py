from .pred_filter import (
    BLOCK_ROWS,
    LAUNCHES,
    OPS,
    block_bounds,
    pack_program,
    pred_filter_batch,
    reset_launches,
)
from .ref import pred_filter_batch_ref, search_iters

__all__ = ["BLOCK_ROWS", "LAUNCHES", "OPS", "block_bounds", "pack_program",
           "pred_filter_batch", "pred_filter_batch_ref", "reset_launches",
           "search_iters"]
