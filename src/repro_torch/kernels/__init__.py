"""Hand-written CUDA kernels of the port, one package per kernel, each with
its plain PyTorch version beside it (``ref.py``)."""
