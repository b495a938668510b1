"""Architecture configs the port runs.

``get_config(arch_id)`` / ``get_reduced(arch_id)`` resolve an arch id to its
full and CPU-sized configuration; ``ARCHS`` lists only the architectures the
port has been carried to (the JAX package's other families come with their
ROADMAP items).
"""
from __future__ import annotations

from typing import List

from . import recurrentgemma_2b, smollm_360m, whisper_tiny
from .base import ModelConfig

#: architectures the port runs, in the JAX registry's id spelling
ARCHS: List[str] = ["whisper-tiny", "smollm-360m", "recurrentgemma-2b"]

_MODULES = {"whisper-tiny": whisper_tiny, "smollm-360m": smollm_360m,
            "recurrentgemma-2b": recurrentgemma_2b}


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"arch {arch_id!r} is not ported (known: "
                       f"{', '.join(ARCHS)})")
    return _MODULES[arch_id]


def get_config(arch_id: str) -> ModelConfig:
    """Full-size configuration of ``arch_id``."""
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    """CPU-sized member of ``arch_id``'s family (2-3 layers)."""
    return _module(arch_id).REDUCED
