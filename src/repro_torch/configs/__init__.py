"""Architecture config registry: ``get(name)`` / ``get_reduced(name)``.

The port carries the configs of the slices it serves (Qwen2-0.5B,
Qwen2-7B) and TinyLlama-1.1B, the artifact CLI's default."""
from __future__ import annotations

import importlib

from .base import ArchConfig  # noqa

_ALIASES = {"qwen2-0.5b": "qwen2_0_5b", "qwen2-0-5b": "qwen2_0_5b",
            "qwen2-7b": "qwen2_7b", "tinyllama-1.1b": "tinyllama_1_1b"}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name)


def get(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.CONFIG


def get_reduced(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.REDUCED

