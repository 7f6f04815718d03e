"""AdamW in PyTorch: the reference's ``optim/adamw.py`` on named tensors.

Parameters, gradients and the moments are mappings from a parameter's name
(``Model.named_parameters()``) to a tensor; m and v are float32 whatever
the parameter's dtype.  One step: float32 gradients (plus the error-feedback
residual), global-norm clipping, optionally the bf16 round trip whose error
the residual keeps, bias-corrected moments, the warm-up and cosine learning
rate, and decoupled weight decay on the float32 parameter, cast back to the
parameter's own dtype.

The step count, the rate and the metrics stay tensors on the parameters'
device, so a step does not wait for the card.  The reference returns new
arrays; :func:`update` writes each new parameter into its tensor in place
(no second copy of the model) and returns a new state.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

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
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
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


def global_norm(tree: Tensors) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum() for x in tree.values()))


@torch.no_grad()
def update(grads: Tensors, state: AdamWState, params: Tensors,
           cfg: AdamWConfig) -> Tuple[Tensors, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step.  Writes the new parameters into ``params`` and
    returns (params, new state, metrics ``grad_norm`` and ``lr``)."""
    step = state.step + 1
    grads = {k: g.float() for k, g in grads.items()}
    if state.residual is not None:
        grads = {k: g + state.residual[k] for k, g in grads.items()}

    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    grads = {k: g * scale for k, g in grads.items()}

    new_res = None
    if state.residual is not None:
        # error feedback: residual = grad - quantized(grad)
        q = {k: g.bfloat16().float() for k, g in grads.items()}
        new_res = {k: g - q[k] for k, g in grads.items()}
        grads = q

    b1, b2 = cfg.beta1, cfg.beta2
    m = {k: b1 * state.m[k] + (1 - b1) * g for k, g in grads.items()}
    v = {k: b2 * state.v[k] + (1 - b2) * g * g for k, g in grads.items()}
    t = step.float()
    bc1 = 1 - torch.pow(b1, t)
    bc2 = 1 - torch.pow(b2, t)
    lr = schedule(step, cfg)

    for k, p in params.items():
        p32 = p.float()
        delta = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + cfg.eps) \
            + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
    return params, AdamWState(step, m, v, new_res), {"grad_norm": gnorm,
                                                      "lr": lr}
