"""Architecture config registry: ``get(name)`` / ``get_reduced(name)``.

The port carries the configs of the slices it serves (Qwen2-0.5B,
Qwen2-7B, the MoE family's Qwen1.5-MoE-A2.7B and Moonlight-16B-A3B) and
TinyLlama-1.1B, the artifact CLI's default."""
from __future__ import annotations

import importlib

from .base import ArchConfig  # noqa

_ALIASES = {"qwen2-0.5b": "qwen2_0_5b", "qwen2-0-5b": "qwen2_0_5b",
            "qwen2-7b": "qwen2_7b", "tinyllama-1.1b": "tinyllama_1_1b",
            "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
            "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b"}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name)


def get(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.CONFIG


def get_reduced(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.REDUCED

