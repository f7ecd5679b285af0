"""Atomic, asynchronous checkpointing of training state."""

from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: F401
