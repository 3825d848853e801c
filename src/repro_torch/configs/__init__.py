"""Architecture registry: maps ``--arch`` ids to ModelConfig instances.

Every assigned architecture has one module in this package carrying the exact
assigned config (with its source citation) plus a reduced smoke variant built
via :func:`repro_torch.config.reduced`.
"""
from __future__ import annotations

from repro_torch.config import ModelConfig, ShapeConfig, SHAPES, reduced, shape_for

from repro_torch.configs.qwen3_1_7b import CONFIG as QWEN3_1_7B
from repro_torch.configs.olmoe_1b_7b import CONFIG as OLMOE_1B_7B
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as LLAMA4_SCOUT
from repro_torch.configs.hymba_1_5b import CONFIG as HYMBA_1_5B
from repro_torch.configs.qwen2_0_5b import CONFIG as QWEN2_0_5B
from repro_torch.configs.rwkv6_7b import CONFIG as RWKV6_7B
from repro_torch.configs.olmo_1b import CONFIG as OLMO_1B
from repro_torch.configs.llama_3_2_vision_90b import CONFIG as LLAMA32_VISION_90B
from repro_torch.configs.command_r_plus_104b import CONFIG as COMMAND_R_PLUS_104B
from repro_torch.configs.whisper_base import CONFIG as WHISPER_BASE

ARCHS = {
    "qwen3-1.7b": QWEN3_1_7B,
    "olmoe-1b-7b": OLMOE_1B_7B,
    "llama4-scout-17b-a16e": LLAMA4_SCOUT,
    "hymba-1.5b": HYMBA_1_5B,
    "qwen2-0.5b": QWEN2_0_5B,
    "rwkv6-7b": RWKV6_7B,
    "olmo-1b": OLMO_1B,
    "llama-3.2-vision-90b": LLAMA32_VISION_90B,
    "command-r-plus-104b": COMMAND_R_PLUS_104B,
    "whisper-base": WHISPER_BASE,
}

ARCH_IDS = tuple(ARCHS)


def get_config(arch: str) -> ModelConfig:
    try:
        return ARCHS[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}") from None


def get_smoke_config(arch: str) -> ModelConfig:
    return reduced(get_config(arch))


__all__ = [
    "ARCHS", "ARCH_IDS", "SHAPES", "ShapeConfig", "ModelConfig",
    "get_config", "get_smoke_config", "reduced", "shape_for",
]
