from .dbgen import generate
from .queries import ALL_QUERIES

__all__ = ["generate", "ALL_QUERIES"]
