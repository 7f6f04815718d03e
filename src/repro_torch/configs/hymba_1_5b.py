"""hymba-1.5b [hybrid]: parallel attention + mamba heads per block; SWA on the
attention branch keeps it sub-quadratic.  [arXiv:2411.13676]"""
from ..models.config import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab=32001, head_dim=64, parallel_ssm=True, ssm=SSMCfg(state_dim=16, expand=1),
    sliding_window=2048,
)
