"""Shared inputs of the LM parity tests: one configuration in both packages,
the reference's random weights carried into the port, and seeded numpy
batches.  The JAX package is imported inside the helpers that need it, so
the card-only tests run where JAX is not installed."""

from __future__ import annotations

import functools
from dataclasses import replace
from typing import Dict

import numpy as np
import torch

from repro_torch import configs as port_configs
from repro_torch.models.model import Model, params_from_numpy


def configs(arch: str, dtype: str = "float32", **kw):
    """(reference config, port config): ``smoke_config(arch)`` with
    ``dtype`` and the overrides ``kw``, remat off (an XLA knob)."""
    from repro import configs as ref_configs

    over = dict(dtype=dtype, remat=False, **kw)
    return (replace(ref_configs.smoke_config(arch), **over),
            replace(port_configs.smoke_config(arch), **over))


@functools.cache
def pair(arch: str, dtype: str = "float32", seed: int = 0, **kw):
    """(reference cfg, reference params, port model on the CPU) holding the
    same float32 weights: the reference's ``M.init(cfg, PRNGKey(seed))``.
    Cached per process: no test writes to the weights."""
    import jax

    from repro.models import model as RM

    rcfg, pcfg = configs(arch, dtype, **kw)
    params, _ = RM.init(rcfg, jax.random.PRNGKey(seed))
    model = params_from_numpy(pcfg, jax.tree.map(np.asarray, params), "cpu")
    return rcfg, params, model


@functools.cache
def ref_decode_step():
    """The reference's ``decode_step`` under ``jax.jit`` (cfg static), as
    its own serving program and smoke test call it; eager dispatch of its
    ops costs about half a second a step."""
    import jax

    from repro.models import model as RM

    return jax.jit(RM.decode_step, static_argnums=3)


def batch(cfg, B: int, S: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded inputs of every family: tokens and labels [B, S], frames [B,
    S, d] for the encoder-decoder, patches [B, n_patches, d] for the VLM."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    b = {"tokens": toks, "labels": toks}
    if cfg.encdec:
        b["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        b["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return b


def to_jax(b):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def f32(x) -> np.ndarray:
    """A JAX array or torch tensor as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def port_model(arch: str, device, dtype: str = "float32", seed: int = 0,
               **kw) -> Model:
    """The port alone: ``Model.init`` of the smoke config on ``device``."""
    cfg = replace(port_configs.smoke_config(arch), dtype=dtype, remat=False, **kw)
    return Model.init(cfg, seed=seed, device=device)
