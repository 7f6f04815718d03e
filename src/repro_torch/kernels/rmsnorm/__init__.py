"""RMSNorm as a CUDA kernel pair (no TPU kernel: the reference's norm is
plain ``jnp``), with its plain version beside it."""
from .ops import BWD_ROWS, D_MAX, LAUNCHES, RMSNorm, reset_launches, rmsnorm
from .ref import rmsnorm_bwd_ref, rmsnorm_fwd_ref, rmsnorm_ref

__all__ = ["BWD_ROWS", "D_MAX", "LAUNCHES", "RMSNorm", "reset_launches", "rmsnorm",
           "rmsnorm_bwd_ref", "rmsnorm_fwd_ref", "rmsnorm_ref"]
