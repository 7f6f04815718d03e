"""Frozen counts and peaks: what the work of a cell is, from its shapes.

Everything here depends on the configuration file's published sizes and
the traffic's shapes alone, whatever implements the work.

* Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
  700 W): 989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM.
* Model FLOPs: a matrix of N entries costs 2 N FLOPs a token forward and
  4 N backward; attention costs 4 H D a (query, key) pair forward (Q K^T
  and P V, 2 H D multiply-adds each) and twice that backward.  Remat's
  recompute and the port's padded vocabulary are not counted: they are
  work the implementation chose, not work the model needs.
* K5 (the causal flash attention kernel): 4 D operations a pair and query
  head forward, 10 D backward (five products); bytes count q, k, v, o (and
  the log-sum-exp where a backward follows) read or written once, k and v
  at the model's KV heads, in the model's dtypes.
"""

from __future__ import annotations

from typing import Optional, Tuple

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}
LSE_BYTES = 4  # the log-sum-exp is float32 whatever the model's dtype


def head_dim(conf: dict) -> int:
    return conf.get("head_dim") or conf["hidden_size"] // conf["num_attention_heads"]


def attention_pairs(s: int, window: Optional[int] = None) -> int:
    """Unmasked (query, key) pairs of causal attention over ``s``
    positions, keys ``window`` or more behind a query masked."""
    w = s if window is None else min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def block_matrix_entries(conf: dict) -> int:
    """Entries of the matrices of one decoder block: the Q, K, V and output
    projections and the gated MLP's three matrices."""
    d, f = conf["hidden_size"], conf["intermediate_size"]
    h, kv, hd = conf["num_attention_heads"], conf["num_key_value_heads"], head_dim(conf)
    return d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * f


def blocks_entries(conf: dict) -> int:
    return conf["num_hidden_layers"] * block_matrix_entries(conf)


def head_entries(conf: dict) -> int:
    """The output head at the published vocabulary."""
    return conf["hidden_size"] * conf["vocab_size"]


def attention_flops(conf: dict, batch: int, seq: int) -> int:
    """Forward attention products of every layer: 4 H D a pair."""
    return (4 * conf["num_attention_heads"] * head_dim(conf)
            * attention_pairs(seq, conf.get("attention_window"))
            * conf["num_hidden_layers"] * batch)


def train_step_flops(conf: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one training step over ``batch`` sequences of
    ``seq`` positions: 6 N a token (N every matrix a token passes through,
    the head included) plus 3 x the forward attention products."""
    n = blocks_entries(conf) + head_entries(conf)
    return 6 * n * batch * seq + 3 * attention_flops(conf, batch, seq)


def _k5_bytes(conf: dict, batch: int, seq: int, per_q: int, per_kv: int) -> int:
    h, kv, hd = conf["num_attention_heads"], conf["num_key_value_heads"], head_dim(conf)
    dt = DTYPE_BYTES[conf.get("torch_dtype", "bfloat16")]
    return batch * seq * hd * dt * (per_q * h + per_kv * kv)


def k5_forward(conf: dict, batch: int, seq: int, lse: bool) -> Tuple[int, int]:
    """(operations, bytes) of one K5 forward launch over ``batch``
    sequences: q and o at the query heads, k and v at the KV heads, and
    the float32 log-sum-exp where a backward reads it (``lse``)."""
    h, hd = conf["num_attention_heads"], head_dim(conf)
    ops = 4 * hd * batch * h * attention_pairs(seq, conf.get("attention_window"))
    nbytes = _k5_bytes(conf, batch, seq, 2, 2)
    if lse:
        nbytes += batch * h * seq * LSE_BYTES
    return ops, nbytes


def k5_backward(conf: dict, batch: int, seq: int) -> Tuple[int, int]:
    """(operations, bytes) of one K5 backward (all its passes): q, o, dO and
    dq at the query heads, k, v, dk and dv at the KV heads, and the
    log-sum-exp."""
    h, hd = conf["num_attention_heads"], head_dim(conf)
    ops = 10 * hd * batch * h * attention_pairs(seq, conf.get("attention_window"))
    nbytes = _k5_bytes(conf, batch, seq, 4, 4) + batch * h * seq * LSE_BYTES
    return ops, nbytes


def bound_s(ops: float, nbytes: float) -> Tuple[float, str]:
    """The least time the card could take: (seconds, "compute" or
    "memory", whichever bounds it)."""
    t_ops, t_bytes = ops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return (t_ops, "compute") if t_ops >= t_bytes else (t_bytes, "memory")
