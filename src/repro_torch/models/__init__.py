"""The port's model stack: the dense, Mamba-1 and hybrid (Mamba-2 + shared
attention) families, served on one card (prefill + greedy decode)."""

from .registry import ModelApi, get_model

__all__ = ["ModelApi", "get_model"]
