"""Checkpoints: atomic, asynchronous, byte-compatible with the JAX package's."""
from .checkpoint import AsyncCheckpointer, latest_step, restore, save  # noqa: F401
