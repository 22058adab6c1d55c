"""Data pipeline of the port (NumPy, host side)."""

from .pipeline import DataConfig, ShardedLoader, SyntheticTokenSource

__all__ = ["DataConfig", "ShardedLoader", "SyntheticTokenSource"]
