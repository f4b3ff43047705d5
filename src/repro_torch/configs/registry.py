"""Registry of the architectures (the reference's
``repro/configs/registry.py``): every arch the reference has, and the
long-context variants that ``get_arch`` picks for the long_500k shape.
The reference's shape-skip table is not carried: nothing in the port
reads it.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (deepseek_moe_16b, dwfl_paper, gemma_2b,
                                 glm4_9b, olmo_1b, qwen2_72b, qwen2_vl_2b,
                                 qwen3_moe_235b_a22b, whisper_medium,
                                 xlstm_1_3b, zamba2_7b)
from repro_torch.configs.base import ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    "zamba2-7b": zamba2_7b.CONFIG,
    "qwen2-vl-2b": qwen2_vl_2b.CONFIG,
    "xlstm-1.3b": xlstm_1_3b.CONFIG,
    "qwen2-72b": qwen2_72b.CONFIG,
    "gemma-2b": gemma_2b.CONFIG,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b.CONFIG,
    "olmo-1b": olmo_1b.CONFIG,
    "glm4-9b": glm4_9b.CONFIG,
    "whisper-medium": whisper_medium.CONFIG,
    "deepseek-moe-16b": deepseek_moe_16b.CONFIG,
    "dwfl-paper": dwfl_paper.DWFL_PAPER,
}


def get_arch(name: str, shape: str | None = None) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    # the long-context shape runs the documented sliding-window variants
    if name == "gemma-2b" and shape == "long_500k":
        return gemma_2b.LONG_CONTEXT_VARIANT
    if name == "zamba2-7b" and shape == "long_500k":
        return zamba2_7b.LONG_CONTEXT_VARIANT
    return ARCHS[name]
