"""Architecture registry: ``get(arch_id)`` resolves the assigned ids.

The id table and ``get`` of ``src/repro/configs/registry.py:31-49``; the
dry-run input specs and the scenario builders of that module wait for the
port's scenario registry.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "gemma3-4b": "gemma3_4b",
    "qwen3-32b": "qwen3_32b",
    "qwen3-8b": "qwen3_8b",
    "llama3.2-3b": "llama32_3b",
    "mixtral-8x22b": "mixtral_8x22b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "mamba2-2.7b": "mamba2_27b",
    "whisper-large-v3": "whisper_large_v3",
    "jamba-v0.1-52b": "jamba_v01_52b",
}

ARCH_IDS = tuple(_MODULES)


def get(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG
