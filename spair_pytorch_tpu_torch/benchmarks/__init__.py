"""Benchmarks of the port that are not its headline (``bench.py``): the
counterparts of the JAX package's ``benchmarks/`` scripts that hold a
kernel."""
