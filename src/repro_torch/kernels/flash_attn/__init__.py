from .flash_attn import LAUNCHES, flash_attention, reset_launches
from .ops import FlashAttention, mha_flash, mha_ref
from .ref import (BF16_RMS_LIMIT, attention_bf16_scores, attention_limit,
                  attention_pairs, attention_ref, rms_ratio)

__all__ = ["BF16_RMS_LIMIT", "FlashAttention", "LAUNCHES",
           "attention_bf16_scores", "attention_limit", "attention_pairs",
           "attention_ref", "flash_attention", "mha_flash",
           "mha_ref", "reset_launches", "rms_ratio"]
