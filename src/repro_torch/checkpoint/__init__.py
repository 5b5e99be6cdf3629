"""Atomic checkpoints (port of ``repro.checkpoint``): the same on-disk
layout, so a checkpoint written by either package loads in the other."""
from .manager import CheckpointManager, load_pytree, save_pytree  # noqa: F401
