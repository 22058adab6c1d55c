"""Checkpoint storage through the burst buffer (:mod:`.tiered_store`).

The asynchronous ``Checkpointer`` of the reference serialises model trees
of the training stack and is not ported yet."""

from .tiered_store import TieredCheckpointStore

__all__ = ["TieredCheckpointStore"]
