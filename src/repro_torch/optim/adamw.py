"""AdamW in PyTorch: the reference's ``optim/adamw.py`` on named tensors.

Parameters, gradients and the moments are mappings from a parameter's name
(``Model.named_parameters()``) to a tensor; m and v are float32 whatever
the parameter's dtype.  One step: float32 gradients (plus the error-feedback
residual), global-norm clipping, optionally the bf16 round trip whose error
the residual keeps, bias-corrected moments, the warm-up and cosine learning
rate, and decoupled weight decay on the float32 parameter, cast back to the
parameter's own dtype.

The step count, the rate and the metrics stay tensors on the parameters'
device, so a step does not wait for the card.  DTensor parameters (a
sharded model) keep m and v in their own layouts, and the clip norm is the
norm over all shards.  The step is elementwise, so it runs on each rank's
own shards as plain tensors (one DTensor dispatch a leaf would cost more
than the arithmetic); only the clip norm's sum crosses ranks, one
``all_reduce`` a mesh dim.  The reference returns new
arrays; :func:`update` writes each new parameter into its tensor in place
(no second copy of the model) and returns a new state.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..compat import DTensor

Tensors = Mapping[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    residual: Optional[Dict[str, torch.Tensor]] = None  # error feedback


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_dtype: Optional[str] = None  # the reference's compressed-reduction knob
    error_feedback: bool = False


def _zeros(params: Tensors) -> Dict[str, torch.Tensor]:
    """float32 zeros in each parameter's layout (a DTensor parameter's
    moments are sharded as it is: ZeRO-sharded by construction)."""
    return {k: torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)
            for k, p in params.items()}


def init(params: Tensors, cfg: AdamWConfig) -> AdamWState:
    """Zero moments (and residual, with ``error_feedback``) in float32."""
    dev = next(iter(params.values())).device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      _zeros(params), _zeros(params),
                      _zeros(params) if cfg.error_feedback else None)


def schedule(step, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warm-up to ``lr``, then a cosine down to ``min_lr_ratio``."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _placed(x, like):
    """``x`` in ``like``'s layout (a DTensor ``x`` redistributed only when
    its placements differ)."""
    if isinstance(x, DTensor) and tuple(x.placements) != tuple(like.placements):
        return x.redistribute(like.device_mesh, like.placements)
    return x


def _wrap(t, like):
    """A rank's own shard ``t`` as a DTensor in ``like``'s layout, when
    ``like`` is a DTensor; otherwise ``t``."""
    if not isinstance(like, DTensor):
        return t
    return DTensor.from_local(t, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def global_norm(tree: Tensors, like: Optional[Tensors] = None) -> torch.Tensor:
    """The norm over every leaf of ``tree``, over all shards of a DTensor
    leaf, or of the DTensor leaf of ``like`` whose shard on this rank
    ``tree`` holds; a plain tensor on every rank.  Each rank's sum of
    squares is divided by the leaf's replica count and summed over every
    mesh dim, so each element counts once."""
    total, mesh = 0, None
    for k, x in tree.items():
        ref = x if like is None else like[k]
        sq = _local(x).float().square().sum()
        if isinstance(ref, DTensor):
            if mesh is not None and ref.device_mesh != mesh:
                raise ValueError("leaves on different meshes")
            mesh = ref.device_mesh
            reps = math.prod(mesh.size(j) for j, pl in enumerate(ref.placements)
                             if not pl.is_shard())
            sq = sq / reps if reps > 1 else sq
        total = total + sq
    if mesh is not None:
        for j in range(mesh.ndim):
            if mesh.size(j) > 1:
                dist.all_reduce(total, group=mesh.get_group(j))
    return torch.sqrt(total)


@torch.no_grad()
def update(grads: Tensors, state: AdamWState, params: Tensors,
           cfg: AdamWConfig) -> Tuple[Tensors, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step.  Writes the new parameters into ``params`` and
    returns (params, new state, metrics ``grad_norm`` and ``lr``).  A
    DTensor parameter's gradient is a DTensor or this rank's shard of it
    in the parameter's layout."""
    step = state.step + 1
    grads = {k: _local(_placed(g, params[k])).float() for k, g in grads.items()}
    if state.residual is not None:
        grads = {k: g + _local(_placed(state.residual[k], params[k]))
                 for k, g in grads.items()}

    gnorm = global_norm(grads, params)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    grads = {k: g * scale for k, g in grads.items()}

    new_res = None
    if state.residual is not None:
        # error feedback: residual = grad - quantized(grad)
        q = {k: g.bfloat16().float() for k, g in grads.items()}
        new_res = {k: _wrap(g - q[k], params[k]) for k, g in grads.items()}
        grads = q

    b1, b2 = cfg.beta1, cfg.beta2
    m = {k: b1 * _local(_placed(state.m[k], params[k])) + (1 - b1) * g
         for k, g in grads.items()}
    v = {k: b2 * _local(_placed(state.v[k], params[k])) + (1 - b2) * g * g
         for k, g in grads.items()}
    t = step.float()
    bc1 = 1 - torch.pow(b1, t)
    bc2 = 1 - torch.pow(b2, t)
    lr = schedule(step, cfg)

    for k, p in params.items():
        local = _local(p)
        p32 = local.float()
        delta = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + cfg.eps) \
            + cfg.weight_decay * p32
        local.copy_(p32 - lr * delta)
    m = {k: _wrap(x, params[k]) for k, x in m.items()}
    v = {k: _wrap(x, params[k]) for k, x in v.items()}
    return params, AdamWState(step, m, v, new_res), {"grad_norm": gnorm,
                                                      "lr": lr}
