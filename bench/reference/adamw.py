"""Plain AdamW with global-norm clipping, the optimizer of the training
cells, in float32.

One step: the gradient's norm over every leaf; every leaf scaled by
``min(clip / norm, 1)``; ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2)
g^2``; bias correction by ``1 - b^t``; the update ``m_hat / (sqrt(v_hat) +
eps) + wd p``, weight decay on every leaf; the rate warms up linearly over
``warmup_steps`` and then follows a cosine to ``min_lr_ratio`` of itself at
``total_steps``.  The new parameter is computed in float32 and stored in
the leaf's own dtype (bf16 for matrices), as the configuration stores it.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def rate(step: int, opt: dict) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * (opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * cos)


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], stored: Dict[str, torch.dtype],
                 opt: dict):
        self.p, self.stored, self.opt = params, stored, opt
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> dict:
        """Writes the parameters in place; returns the gradient's norm
        before clipping, the rate, and each leaf's clipped gradient norm."""
        o = self.opt
        self.t += 1
        norm = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
        scale = min(o["clip_norm"] / max(norm, 1e-9), 1.0)
        b1, b2, t = o["beta1"], o["beta2"], self.t
        lr = rate(t, o)
        leaf_norms = {}
        for k, p in self.p.items():
            g = grads[k] * scale
            leaf_norms[k] = float(g.norm())
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).add_(g * g, alpha=1 - b2)
            upd = (self.m[k] / (1 - b1 ** t)) / ((self.v[k] / (1 - b2 ** t)).sqrt()
                                                 + o["eps"]) + o["weight_decay"] * p
            p.copy_((p - lr * upd).to(self.stored[k]).to(torch.float32))
        return {"grad_norm": norm, "lr": lr, "leaf_norms": leaf_norms}
