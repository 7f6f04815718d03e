from .flash_attn import (LAUNCHES, flash_attention, flash_attention_backward,
                         flash_attention_fwd, reset_launches)
from .ops import FlashAttention, mha_flash, mha_ref
from .ref import (BF16_RMS_LIMIT, BWD_BF16_RMS_LIMIT, attention_bf16_scores,
                  attention_bwd_bf16, attention_bwd_bf16_scores,
                  attention_bwd_limit, attention_bwd_ref, attention_limit,
                  attention_lse_ref, attention_pairs, attention_ref, rms_ratio)

__all__ = ["BF16_RMS_LIMIT", "BWD_BF16_RMS_LIMIT", "FlashAttention",
           "LAUNCHES", "attention_bf16_scores", "attention_bwd_bf16",
           "attention_bwd_bf16_scores", "attention_bwd_limit", "attention_bwd_ref",
           "attention_limit", "attention_lse_ref", "attention_pairs",
           "attention_ref", "flash_attention", "flash_attention_backward",
           "flash_attention_fwd", "mha_flash", "mha_ref", "reset_launches",
           "rms_ratio"]
