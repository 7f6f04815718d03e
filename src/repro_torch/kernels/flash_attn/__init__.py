from .flash_attn import LAUNCHES, flash_attention, reset_launches
from .ops import mha_flash, mha_ref
from .ref import attention_ref

__all__ = ["LAUNCHES", "attention_ref", "flash_attention", "mha_flash",
           "mha_ref", "reset_launches"]
