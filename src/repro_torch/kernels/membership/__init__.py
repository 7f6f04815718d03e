from .membership import BLOCK_ROWS, LAUNCHES, SET_TILE, membership, reset_launches
from .ops import SENTINEL, probe
from .ref import membership_ref

__all__ = ["BLOCK_ROWS", "LAUNCHES", "SENTINEL", "SET_TILE", "membership",
           "membership_ref", "probe", "reset_launches"]
