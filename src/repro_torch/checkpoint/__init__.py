"""Checkpoints with async save and restart discovery — counterpart of
:mod:`repro.checkpoint`, in its on-disk layout."""
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: F401
