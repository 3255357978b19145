"""Checkpointing of the port, as ``repro.checkpoint``."""
from repro_torch.checkpoint.ckpt import Checkpointer

__all__ = ["Checkpointer"]
