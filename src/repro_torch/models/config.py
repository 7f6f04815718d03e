"""Architecture configuration for the model zoo (the 10 assigned archs)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    group_size: int = 512  # GShard-style token grouping for dispatch
    sharding: str = "tp"  # "tp": experts' d_ff sharded | "ep": experts sharded


@dataclass(frozen=True)
class SSMCfg:
    state_dim: int = 16
    expand: int = 1  # d_inner = expand * d_model
    conv_width: int = 4


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio(encdec)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0  # glm4: 0.5 (partial rotary)
    sliding_window: Optional[int] = None  # SWA width (mixtral 4096, hymba 2048)
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    # hybrid (hymba): every block runs attention and SSM branches in parallel
    parallel_ssm: bool = False
    # xlstm: block i is sLSTM when (i % slstm_every == slstm_every-1)
    xlstm: bool = False
    slstm_every: int = 4
    # encoder-decoder (seamless): n_layers applies to both stacks
    encdec: bool = False
    # modality frontend stub: 'none' | 'vision' | 'audio'
    frontend: str = "none"
    n_patches: int = 256  # vision stub: patch positions prepended
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # training-time knobs (overridable per run)
    remat: bool = True
    accum_steps: int = 1
    attn_impl: str = "xla"  # "xla" | "pallas"
    # analysis-only: fully unroll layer scans so the dry-run cost analysis
    # counts every layer (XLA counts a scan body once regardless of trips)
    scan_unroll: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a TP-shardable multiple (2048 covers model=16 with
        128-lane tiles).  Unpadded vocabs like seamless's 256206 silently
        replicate the vocab dim -> full-vocab logits per device."""
        m = 2048
        return ((self.vocab + m - 1) // m) * m

    @property
    def sub_quadratic(self) -> bool:
        """Bounded per-token state: SSM/hybrid/xLSTM or sliding-window attn."""
        return self.xlstm or self.parallel_ssm or self.sliding_window is not None

    def supports_shape(self, shape: str) -> Tuple[bool, str]:
        if shape == "long_500k" and not self.sub_quadratic:
            return False, "pure full attention: O(seq^2)/unbounded KV at 524288 (DESIGN.md §6)"
        return True, ""


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
