"""Persistence: the compressed intermediate store (``store_io``) and the
training checkpoints (``manager``)."""
