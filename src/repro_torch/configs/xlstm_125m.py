"""xlstm-125m [ssm]: mLSTM + sLSTM blocks at 7:1 (d_ff=0: no separate FFN).
[arXiv:2405.04517]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, xlstm=True, slstm_every=4,
)
