"""Architecture configs the port runs.

``get_config(arch_id)`` / ``get_reduced(arch_id)`` resolve an arch id to its
full and CPU-sized configuration; ``ARCHS`` lists all ten of the JAX
registry's architectures, in its order, and ``SHAPES`` the reference's four
input shapes.  ``PORT_ONLY`` lists the architectures the port runs that the
JAX package has no model of (outside ``ARCHS``, whose every entry the
tests hold to the JAX package's).
"""
from __future__ import annotations

from typing import Dict, List

from . import (arctic_480b, chatglm3_6b, gemma3_1b, internvl2_2b,
               k_exaone_236b, llama4_scout_17b_a16e, mistral_large_123b,
               recurrentgemma_2b, rwkv6_7b, smollm_360m, whisper_tiny)
from .base import ModelConfig

#: architectures the port runs, in the JAX registry's id spelling and order
ARCHS: List[str] = ["arctic-480b", "rwkv6-7b", "llama4-scout-17b-a16e",
                    "whisper-tiny", "chatglm3-6b", "internvl2-2b",
                    "smollm-360m", "gemma3-1b", "mistral-large-123b",
                    "recurrentgemma-2b"]

#: the four assigned input shapes: name -> (seq_len, global_batch, kind)
SHAPES: Dict[str, tuple] = {
    "train_4k":    (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k":  (32_768, 128, "decode"),
    "long_500k":   (524_288, 1, "decode"),
}

_MODULES = {"arctic-480b": arctic_480b, "rwkv6-7b": rwkv6_7b,
            "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
            "whisper-tiny": whisper_tiny, "chatglm3-6b": chatglm3_6b,
            "internvl2-2b": internvl2_2b, "smollm-360m": smollm_360m,
            "gemma3-1b": gemma3_1b,
            "mistral-large-123b": mistral_large_123b,
            "recurrentgemma-2b": recurrentgemma_2b,
            "k-exaone-236b-a23b": k_exaone_236b}

#: architectures of the port alone (no JAX counterpart)
PORT_ONLY: List[str] = ["k-exaone-236b-a23b"]


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"arch {arch_id!r} is not ported (known: "
                       f"{', '.join(ARCHS + PORT_ONLY)})")
    return _MODULES[arch_id]


def get_config(arch_id: str) -> ModelConfig:
    """Full-size configuration of ``arch_id``."""
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    """CPU-sized member of ``arch_id``'s family (2-3 layers)."""
    return _module(arch_id).REDUCED


def all_configs() -> Dict[str, ModelConfig]:
    """Every architecture's full-size configuration, in ``ARCHS`` order."""
    return {a: get_config(a) for a in ARCHS}
