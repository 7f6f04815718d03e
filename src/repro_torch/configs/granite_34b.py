"""granite-34b [dense]: 88-layer MQA (kv=1) code model, llama-arch.
[arXiv:2405.04324]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
    vocab=49152,
)
