"""mixtral-8x22b [moe]: 8 experts top-2, SWA(4096).  Largest assigned model —
requires FSDP x TP.  [arXiv:2401.04088]"""
from ..models.config import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=32768, sliding_window=4096,
    moe=MoECfg(num_experts=8, top_k=2, group_size=256),
)
