"""The steps of a :class:`Model` built for ``cfg``: one training step
(microbatch accumulation, then AdamW), one prefill and one decode step.

Mesh sharding and the dry run's abstract shapes are not ported.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from ..models.config import ArchConfig
from ..models.model import Model
from ..optim import adamw


def _check(model: Model, cfg: ArchConfig) -> None:
    if model.cfg != cfg:
        raise ValueError(f"step made for {cfg.name}, model is {model.cfg.name} "
                         f"or another configuration of it")


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig):
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``.  The batch is cut into ``cfg.accum_steps`` microbatches
    along its first dimension; their gradients are summed in float32 and
    divided by the count, the loss averaged; then one :func:`adamw.update`
    writes the model's weights.  Metrics ``loss``, ``grad_norm`` and ``lr``
    are tensors on the model's device."""

    def train_step(model: Model, opt_state: adamw.AdamWState,
                   batch: Mapping[str, torch.Tensor]):
        _check(model, cfg)
        A = max(cfg.accum_steps, 1)
        B = next(iter(batch.values())).shape[0]
        if B % A:
            raise ValueError(f"batch {B} does not split into {A} microbatches")
        params = dict(model.named_parameters())
        names, leaves = list(params), list(params.values())
        grads: Dict[str, torch.Tensor] = {}
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        for a in range(A):
            mb = {k: v[a * B // A:(a + 1) * B // A] for k, v in batch.items()}
            with torch.enable_grad():
                mb_loss = model.loss_fn(mb)
                mb_grads = torch.autograd.grad(mb_loss, leaves)
            loss += mb_loss.detach()
            for n, g in zip(names, mb_grads):
                grads[n] = grads[n].add_(g) if n in grads else g.float()
            del mb_loss, mb_grads
        if A > 1:
            grads = {n: g / A for n, g in grads.items()}
            loss = loss / A
        _, opt_state, metrics = adamw.update(grads, opt_state, params, opt_cfg)
        metrics["loss"] = loss
        return model, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(model: Model, batch):
        _check(model, cfg)
        return model.prefill(batch)

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    def serve_step(model: Model, state, tokens):
        _check(model, cfg)
        return model.decode_step(state, tokens)

    return serve_step
