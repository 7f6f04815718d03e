"""Persistence of the port's compressed intermediate store (``store_io``)."""
