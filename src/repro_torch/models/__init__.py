"""The port's model stack: the dense and Mamba-1 families, served on one
card (prefill + greedy decode)."""

from .registry import ModelApi, get_model

__all__ = ["ModelApi", "get_model"]
