"""Utilities: config persistence and logging (copies of the JAX package's)."""
