"""Checkpointing of the port: ``repro.checkpoint`` with the same layout on
disk."""
from .checkpointer import Checkpointer

__all__ = ["Checkpointer"]
