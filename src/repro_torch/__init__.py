"""PyTorch/CUDA port of PredTrace (row-level lineage via predicate pushdown).

The JAX package ``repro`` is the reference; this package mirrors its module
names and layout and never imports it (nor ``jax``).  Device scans run
through hand-written CUDA kernels (``repro_torch.kernels``); host-side
relational code stays numpy, as in the reference.
"""
