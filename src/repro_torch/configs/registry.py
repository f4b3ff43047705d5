"""Registry of the architectures (the reference's
``repro/configs/registry.py``): every arch the reference has, and the
long-context variants that ``get_arch`` picks for the long_500k shape,
``ASSIGNED`` and the reference's designed skips of the (arch x shape) grid
(``SHAPE_SKIPS``), which the dry run (``launch.dryrun``) reads, with its
two readers ``applicable`` and ``all_pairs``.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (deepseek_moe_16b, dwfl_paper, gemma_2b,
                                 glm4_9b, olmo_1b, qwen2_72b, qwen2_vl_2b,
                                 qwen3_moe_235b_a22b, whisper_medium,
                                 xlstm_1_3b, zamba2_7b)
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

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

ASSIGNED = [a for a in ARCHS if a != "dwfl-paper"]

# (arch, shape) pairs skipped by design: long_500k needs sub-quadratic
# attention or a recurrent state
SHAPE_SKIPS = {
    ("qwen2-72b", "long_500k"): "pure full attention; 524k dense KV out of scope",
    ("olmo-1b", "long_500k"): "pure full attention",
    ("glm4-9b", "long_500k"): "pure full attention",
    ("qwen2-vl-2b", "long_500k"): "pure full attention",
    ("qwen3-moe-235b-a22b", "long_500k"): "full attention MoE",
    ("deepseek-moe-16b", "long_500k"): "full attention MoE",
    ("whisper-medium", "long_500k"): "enc-dec; decoder context architecturally <=448",
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


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def applicable(arch: str, shape: str) -> bool:
    """False for a pair the grid skips by design (``SHAPE_SKIPS``)."""
    return (arch, shape) not in SHAPE_SKIPS


def all_pairs():
    """The assigned archs x shapes grid, each pair with its skip reason
    (None where it runs), in the reference's order."""
    for a in ASSIGNED:
        for s in SHAPES:
            yield a, s, SHAPE_SKIPS.get((a, s))
