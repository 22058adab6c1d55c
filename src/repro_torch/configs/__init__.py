"""Architecture configs of the port: one module per ported arch
(``--arch <id>``), each exporting ``CONFIG`` (the published shape) and
``SMOKE`` (a reduced same-family config for CPU tests).

The dense, Mamba-1 and hybrid (Mamba-2 + shared attention) families serve
so far; the reference's MoE, encoder-decoder and VLM architectures wait for
their slice of the port (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import importlib

from .base import ModelConfig, smoke_variant

ARCHITECTURES = ["qwen3-1.7b", "stablelm-3b", "starcoder2-3b", "phi4-mini-3.8b", "zamba2-2.7b",
                 "falcon-mamba-7b"]


def _module(arch: str):
    if arch not in ARCHITECTURES:
        raise NotImplementedError(
            f"{arch!r} is not ported yet (ROADMAP.md, Queue 1); the port "
            f"serves {ARCHITECTURES}")
    # qwen3-1.7b -> qwen3_1p7b (dashes -> _, dots -> p)
    return importlib.import_module(
        f"{__name__}.{arch.replace('-', '_').replace('.', 'p')}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


__all__ = ["ARCHITECTURES", "ModelConfig", "get_config", "get_smoke_config",
           "smoke_variant"]
