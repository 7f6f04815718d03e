"""Roofline accounting from a traced step on one rank.

Terms (all PER-DEVICE: rank 0's own work in the dry run's trace,
``launch/dryrun.py``):

  compute    = FLOPs / PEAK_FLOPS
  memory     = bytes / HBM_BW
  collective = sum over collectives of ring wire-time at LINK_BW

NVIDIA H100 SXM constants, not the TPU v5e's of the reference: 989 TFLOP/s
dense bf16 on the tensor cores, 3.35 TB/s HBM3 (NVIDIA's H100 data sheet,
at the card's 700 W limit), and 450 GB/s for one direction of one card's
NVLink 4 (18 links of 25 GB/s each way, 900 GB/s both ways together; the
same data sheet).  A ring collective over the cards of one host moves its
bytes through each card's links, so its wire time is its wire bytes over
that one direction's rate.

PyTorch has no HLO to read, so nothing here parses one: the dry run's trace
hands :func:`analyze` its counters (:class:`TraceCounts`), and each
collective it saw as ``(kind, output bytes, group size)``, whose wire bytes
:func:`wire_bytes` gives by the reference's ring formulas.  The pure
functions below (:func:`combine_delta`, :func:`ssm_scan_correction`,
:func:`model_flops_per_step`, :func:`total_params`, :func:`active_params`)
are the reference's, unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def wire_bytes(kind: str, out_bytes: float, group_size: int) -> float:
    """Bytes one rank sends for a ring collective whose output on that rank
    is ``out_bytes``, over a group of ``group_size`` ranks."""
    G, B = group_size, float(out_bytes)
    if G <= 1:
        return 0.0
    if kind == "all-gather":
        return B * (G - 1) / G
    if kind == "all-reduce":
        return 2 * B * (G - 1) / G
    if kind == "reduce-scatter":
        return B * (G - 1)  # out is the scattered shard
    if kind == "all-to-all":
        return B * (G - 1) / G
    if kind == "collective-permute":
        return B
    raise ValueError(f"unknown collective {kind!r}; have {COLLECTIVES}")


@dataclass
class CollectiveOp:
    kind: str
    out_bytes: int
    group_size: int
    wire_bytes: float = 0.0


def collective(kind: str, out_bytes: int, group_size: int) -> CollectiveOp:
    return CollectiveOp(kind, out_bytes, max(group_size, 1),
                        wire_bytes(kind, out_bytes, max(group_size, 1)))


@dataclass
class TraceCounts:
    """What one traced step did on one rank.  ``arg_bytes``: live when the
    step starts (the rank's weights, optimizer state and batch);
    ``peak_bytes``: the most live at once during it; ``end_bytes``: live
    when it returns."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collectives: List[CollectiveOp] = field(default_factory=list)
    arg_bytes: int = 0
    peak_bytes: int = 0
    end_bytes: int = 0


@dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    collective_wire_bytes: float
    collective_breakdown: Dict[str, float]
    arg_bytes: int = 0
    temp_bytes: int = 0
    out_bytes: int = 0
    alias_bytes: int = 0  # donated in/out aliasing (e.g. KV caches)

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_wire_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def per_device_hbm_bytes(self) -> int:
        # aliased outputs (donated buffers) are not extra allocations
        return self.arg_bytes + self.temp_bytes + self.out_bytes - self.alias_bytes

    def to_dict(self) -> Dict:
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_wire_bytes": self.collective_wire_bytes,
            "collective_breakdown": self.collective_breakdown,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "arg_bytes": self.arg_bytes,
            "temp_bytes": self.temp_bytes,
            "out_bytes": self.out_bytes,
            "alias_bytes": self.alias_bytes,
        }


def analyze(counts: TraceCounts) -> Roofline:
    """The roofline of one traced step.  Memory keeps the reference's sum:
    ``arg`` (live at the start) + ``temp`` (the rest of the peak) + ``out``
    (new storage still live at the end, the step's outputs) is the peak.
    The port updates weights, optimizer state and decode caches in place,
    so nothing is aliased."""
    breakdown: Dict[str, float] = {}
    for c in counts.collectives:
        breakdown[c.kind] = breakdown.get(c.kind, 0.0) + c.wire_bytes
    out = max(counts.end_bytes - counts.arg_bytes, 0)
    temp = max(counts.peak_bytes - counts.arg_bytes - out, 0)
    return Roofline(float(counts.flops), float(counts.bytes_accessed),
                    sum(c.wire_bytes for c in counts.collectives), breakdown,
                    counts.arg_bytes, temp, out)


def combine_delta(c_small: "Roofline", c_big: "Roofline", l_small: int, l_big: int,
                  l_full: int) -> "Roofline":
    """Extrapolate per-device costs to the full layer count from two
    fully-unrolled analysis lowerings: per-layer delta is exact, so
    total(L) = C(ls) + (L - ls) * (C(lb) - C(ls)) / (lb - ls)."""
    per = {}
    for field_ in ("flops", "bytes_accessed", "collective_wire_bytes"):
        a, b = getattr(c_small, field_), getattr(c_big, field_)
        d = (b - a) / max(l_big - l_small, 1)
        per[field_] = a + (l_full - l_small) * d
    breakdown = {}
    for k in set(c_small.collective_breakdown) | set(c_big.collective_breakdown):
        a = c_small.collective_breakdown.get(k, 0.0)
        b = c_big.collective_breakdown.get(k, 0.0)
        d = (b - a) / max(l_big - l_small, 1)
        breakdown[k] = max(a + (l_full - l_small) * d, 0.0)
    return Roofline(
        max(per["flops"], 0.0),
        max(per["bytes_accessed"], 0.0),
        max(per["collective_wire_bytes"], 0.0),
        breakdown,
    )


def ssm_scan_correction(cfg, shape, batch_shard: int, model_shard: int):
    """Analytic per-device (flops, bytes) for sequence-recurrent scans, which
    XLA's cost analysis counts once regardless of trip count and which cannot
    be unrolled (4096+ steps).  Training multiplier 4x fwd (fwd + ~2x bwd +
    remat re-fwd); prefill 1x; decode steps are exact already (single trip).
    """
    if shape.kind == "decode":
        return 0.0, 0.0
    mult = 4.0 if shape.kind == "train" else 1.0
    B_local = max(shape.global_batch // batch_shard, 1)
    S = shape.seq_len
    flops = 0.0
    nbytes = 0.0
    if cfg.parallel_ssm and cfg.ssm is not None:
        dI = cfg.ssm.expand * cfg.d_model
        dI_l = dI // model_shard if dI % model_shard == 0 else dI
        N = cfg.ssm.state_dim
        flops += cfg.n_layers * S * B_local * 9.0 * dI_l * N
        nbytes += cfg.n_layers * S * B_local * 12.0 * dI_l * N  # h f32 rw-dominated
    if cfg.xlstm:
        d = cfg.d_model
        H = cfg.n_heads
        d_in = 2 * d
        dh = d_in // H
        n_sl = cfg.n_layers // cfg.slstm_every
        n_ml = cfg.n_layers - n_sl
        flops += n_ml * S * B_local * 7.0 * H * dh * dh
        nbytes += n_ml * S * B_local * 12.0 * H * dh * dh  # C f32 rw
        flops += n_sl * S * B_local * 8.0 * d * d  # recurrent gate matmul
        nbytes += n_sl * S * B_local * 4.0 * d * 4 * d  # R re-read per step
    return flops * mult, nbytes * mult


def model_flops_per_step(cfg, shape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) for a train step; for decode/prefill
    2*N_active*D_tokens (fwd only)."""
    n_active = active_params(cfg)
    toks = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * toks


def total_params(cfg) -> float:
    return _params(cfg, active_only=False)


def active_params(cfg) -> float:
    return _params(cfg, active_only=True)


def _params(cfg, active_only: bool) -> float:
    d, hd = cfg.d_model, cfg.hd
    attn = d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
    if cfg.moe is not None:
        e = cfg.moe.top_k if active_only else cfg.moe.num_experts
        ffn = 3 * d * cfg.d_ff * e + d * cfg.moe.num_experts
    else:
        ffn = 3 * d * cfg.d_ff if cfg.d_ff else 0
    if cfg.parallel_ssm:
        di = cfg.ssm.expand * d
        ffn += 2 * d * di + di * (di + 2 * cfg.ssm.state_dim) + di * d
    block = attn + ffn
    if cfg.xlstm:
        d_in = 2 * d
        dh = d_in // cfg.n_heads
        ml = d * d_in * 2 + d_in * (3 * d_in + 2 * cfg.n_heads) + d_in * d
        sl = d * 4 * d * 2 + d * d
        n_sl = cfg.n_layers // cfg.slstm_every
        body = ml * (cfg.n_layers - n_sl) + sl * n_sl
    else:
        body = block * cfg.n_layers * (2 if cfg.encdec else 1)
    embed = cfg.vocab * d * 2
    return float(body + embed)
