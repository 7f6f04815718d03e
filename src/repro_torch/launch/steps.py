"""The serving steps: one prefill and one decode step of a :class:`Model`
built for ``cfg``.

Training, mesh sharding and the dry run's abstract shapes are not ported.
"""

from __future__ import annotations

from ..models.config import ArchConfig
from ..models.model import Model


def _check(model: Model, cfg: ArchConfig) -> None:
    if model.cfg != cfg:
        raise ValueError(f"step made for {cfg.name}, model is {model.cfg.name} "
                         f"or another configuration of it")


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
