"""Architecture configs of the port: one module per ported arch
(``--arch <id>``), each exporting ``CONFIG`` (the published shape) and
``SMOKE`` (a reduced same-family config for CPU tests).

All ten of the reference's architectures: dense, MoE (top-k routed
experts), VLM (prefix patch embeddings), encoder-decoder (whisper-tiny),
Mamba-1 and the hybrid (Mamba-2 + shared attention).
"""

from __future__ import annotations

import importlib

from .base import SHAPE_CELLS, ModelConfig, ShapeCell, applicable_cells, smoke_variant

ARCHITECTURES = ["qwen3-1.7b", "stablelm-3b", "starcoder2-3b", "phi4-mini-3.8b",
                 "moonshot-v1-16b-a3b", "grok-1-314b", "internvl2-26b", "whisper-tiny",
                 "zamba2-2.7b", "falcon-mamba-7b"]


def _module(arch: str):
    if arch not in ARCHITECTURES:
        raise ValueError(f"unknown arch {arch!r}; the port serves {ARCHITECTURES}")
    # qwen3-1.7b -> qwen3_1p7b (dashes -> _, dots -> p)
    return importlib.import_module(
        f"{__name__}.{arch.replace('-', '_').replace('.', 'p')}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


__all__ = ["ARCHITECTURES", "ModelConfig", "SHAPE_CELLS", "ShapeCell", "applicable_cells",
           "get_config", "get_smoke_config", "smoke_variant"]
