"""Architecture registry: the 10 assigned architectures (+ reduced smoke
variants) selectable via ``--arch <id>``."""
from dataclasses import replace

from ..models.config import ArchConfig, MoECfg, SSMCfg, SHAPES, ShapeConfig
from .phi_3_vision_4_2b import CONFIG as PHI3V
from .hymba_1_5b import CONFIG as HYMBA
from .granite_34b import CONFIG as GRANITE
from .llama3_2_3b import CONFIG as LLAMA32
from .qwen2_0_5b import CONFIG as QWEN2
from .glm4_9b import CONFIG as GLM4
from .seamless_m4t_medium import CONFIG as SEAMLESS
from .mixtral_8x22b import CONFIG as MIXTRAL
from .olmoe_1b_7b import CONFIG as OLMOE
from .xlstm_125m import CONFIG as XLSTM

REGISTRY = {c.name: c for c in [
    PHI3V, HYMBA, GRANITE, LLAMA32, QWEN2, GLM4, SEAMLESS, MIXTRAL, OLMOE, XLSTM,
]}


def get(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests: few layers, narrow
    width, tiny vocab/experts — structure preserved."""
    c = get(name)
    heads = min(c.n_heads, 4)
    kv = min(c.n_kv_heads, heads)
    heads = (heads // kv) * kv  # keep GQA ratio valid
    kw = dict(
        n_layers=min(c.n_layers, 4) if not c.xlstm else 4,
        d_model=128, n_heads=heads, n_kv_heads=kv, head_dim=32,
        d_ff=0 if c.d_ff == 0 else 256, vocab=512,
        sliding_window=min(c.sliding_window, 16) if c.sliding_window else None,
        n_patches=8,
    )
    if c.moe is not None:
        kw["moe"] = MoECfg(num_experts=4, top_k=min(c.moe.top_k, 2), group_size=32)
    if c.ssm is not None:
        kw["ssm"] = SSMCfg(state_dim=4, expand=c.ssm.expand)
    return replace(c, **kw)


__all__ = ["REGISTRY", "get", "smoke_config", "SHAPES", "ShapeConfig", "ArchConfig"]
