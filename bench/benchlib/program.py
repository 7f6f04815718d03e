"""The system under test: the port (``repro_torch``), reached only here.

The benchmark takes from the port its configuration type, its ``Model``,
its step builders and its optimizer; it gives the port the benchmark's own
weights and inputs.  Imports of the port happen inside the functions, so
this module loads where the port is absent (the harness then fails when a
cell starts, never on import).
"""

from __future__ import annotations

from typing import Dict

import torch

PORT_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def arch(conf: dict, **training):
    """The port's ``ArchConfig`` of a configuration file: its published
    sizes, its norm epsilon and RoPE base, its QKV bias and, for a vision
    configuration, its stubbed tower's ``n_patches``; ``training`` sets
    ``remat`` and ``accum_steps``."""
    from repro_torch.models.config import ArchConfig

    vision = bool(conf.get("n_patches"))
    extra = {"n_patches": conf["n_patches"]} if vision else {}
    return ArchConfig(
        name=conf["name"], family="vlm" if vision else "dense",
        n_layers=conf["num_hidden_layers"], d_model=conf["hidden_size"],
        n_heads=conf["num_attention_heads"], n_kv_heads=conf["num_key_value_heads"],
        d_ff=conf["intermediate_size"], vocab=conf["vocab_size"],
        head_dim=conf.get("head_dim"), qkv_bias=bool(conf.get("qkv_bias")),
        rope_theta=float(conf["rope_theta"]), norm_eps=float(conf["rms_norm_eps"]),
        frontend="vision" if vision else "none", dtype=conf["torch_dtype"],
        **extra, **training)


def _padded(name: str, t: torch.Tensor, vocab: int, padded: int) -> torch.Tensor:
    """The published ``embed [V, d]`` / ``lm_head [d, V]`` in the port's
    padded layout, the padding zero; other leaves as they are."""
    if padded == vocab or name not in ("embed", "lm_head"):
        return t
    dim = 0 if name == "embed" else 1
    shape = list(t.shape)
    shape[dim] = padded
    out = torch.zeros(shape, dtype=t.dtype, device=t.device)
    out.narrow(dim, 0, vocab).copy_(t)
    return out


def published(name: str, t: torch.Tensor, vocab: int) -> torch.Tensor:
    """A port leaf (or a tensor shaped as one) cut to the published
    vocabulary."""
    if name == "embed":
        return t[:vocab]
    if name == "lm_head":
        return t[:, :vocab]
    return t


def model(cfg, weights: Dict[str, torch.Tensor]):
    """The port's ``Model`` holding ``weights`` (the tensors themselves,
    but for the padded embedding and head)."""
    from repro_torch.models.model import Model

    state = {k: _padded(k, v, cfg.vocab, cfg.padded_vocab) for k, v in weights.items()}
    m = Model(cfg, device="meta", dtype=PORT_DTYPES[cfg.dtype])
    m.load_state_dict(state, strict=True, assign=True)
    return m


def adamw(opt: dict):
    from repro_torch.optim import adamw as port_adamw

    keys = ("lr", "beta1", "beta2", "eps", "weight_decay", "clip_norm",
            "warmup_steps", "total_steps", "min_lr_ratio")
    return port_adamw.AdamWConfig(**{k: opt[k] for k in keys})


def adamw_init(m, opt_cfg):
    from repro_torch.optim import adamw as port_adamw

    return port_adamw.init(dict(m.named_parameters()), opt_cfg)


def train_step(cfg, opt_cfg):
    from repro_torch.launch.steps import make_train_step

    return make_train_step(cfg, opt_cfg)


def k5_launches() -> Dict[str, int]:
    """The port's K5 launch counters (forward, backward)."""
    from repro_torch.kernels.flash_attn import LAUNCHES

    return dict(LAUNCHES)
