"""Registry of the ported architectures (the reference's
``repro/configs/registry.py``, restricted to what the port runs).

``ARCHS`` holds dwfl-paper, the five archs whose family routes to the
dense transformer (dense and vlm) and the hybrid zamba2-7b. The
reference's other archs are known by name; asking for one raises, naming
the ROADMAP item that ports it.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (dwfl_paper, gemma_2b, glm4_9b, olmo_1b,
                                 qwen2_72b, qwen2_vl_2b, zamba2_7b)
from repro_torch.configs.base import ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    "zamba2-7b": zamba2_7b.CONFIG,
    "qwen2-vl-2b": qwen2_vl_2b.CONFIG,
    "qwen2-72b": qwen2_72b.CONFIG,
    "gemma-2b": gemma_2b.CONFIG,
    "olmo-1b": olmo_1b.CONFIG,
    "glm4-9b": glm4_9b.CONFIG,
    "dwfl-paper": dwfl_paper.DWFL_PAPER,
}

# the reference's archs not ported yet -> the ROADMAP item that ports them
NOT_PORTED = {
    "xlstm-1.3b": "A15 (xlstm)",
    "qwen3-moe-235b-a22b": "A15 (moe)",
    "deepseek-moe-16b": "A15 (moe)",
    "whisper-medium": "A15 (encdec)",
}


def get_arch(name: str, shape: str | None = None) -> ModelConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(f"arch {name!r} is not ported to repro_torch "
                                  f"yet (ROADMAP {NOT_PORTED[name]})")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(ARCHS) + sorted(NOT_PORTED)}")
    # the long-context shape runs the documented sliding-window variants
    if name == "gemma-2b" and shape == "long_500k":
        return gemma_2b.LONG_CONTEXT_VARIANT
    if name == "zamba2-7b" and shape == "long_500k":
        return zamba2_7b.LONG_CONTEXT_VARIANT
    return ARCHS[name]
