"""seamless-m4t-medium [audio]: enc-dec transformer backbone; the audio
frontend is a stub (precomputed frame embeddings).  [arXiv:2308.11596]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=256206, encdec=True, frontend="audio",
)
