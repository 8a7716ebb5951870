"""Utilities: config persistence and logging (copies of the JAX package's)
and profiling (FPS counter, stage timer, torch.profiler trace)."""
