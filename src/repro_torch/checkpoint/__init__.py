"""Checkpoint substrate: the tiered store through the burst buffer
(:mod:`.tiered_store`) and asynchronous saves (:mod:`.checkpointer`)."""

from .checkpointer import Checkpointer
from .tiered_store import TieredCheckpointStore

__all__ = ["Checkpointer", "TieredCheckpointStore"]
