"""The benchmark's own code: the manifest's rules, the frozen counts and
peaks, the reduction of a device trace, the seeded weights and inputs, and
the run of one cell.  Nothing here imports ``jax`` or the JAX package;
only :mod:`benchlib.program` and the drivers touch the port."""
