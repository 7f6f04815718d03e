"""glm4-9b [dense]: partial RoPE (half dims), GQA kv=2.  [hf:THUDM/glm-4-9b]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab=151552, rope_fraction=0.5,
)
