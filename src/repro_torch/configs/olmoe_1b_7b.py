"""olmoe-1b-7b [moe]: 64 experts top-8, small d_ff.  [arXiv:2409.02060]"""
from ..models.config import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1024,
    vocab=50304,
    moe=MoECfg(num_experts=64, top_k=8, group_size=128),
)
