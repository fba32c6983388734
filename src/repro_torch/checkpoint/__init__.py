"""Atomic checkpoints (counterpart of `repro.checkpoint`)."""

from .checkpoint import all_steps, latest_step, restore, save  # noqa: F401
