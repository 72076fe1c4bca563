"""Architecture config registry: ``get(name)`` / ``get_reduced(name)``.

The port carries the configs of the slices it serves (Qwen2-0.5B)."""
from __future__ import annotations

import importlib

from .base import ArchConfig  # noqa

_ALIASES = {"qwen2-0.5b": "qwen2_0_5b", "qwen2-0-5b": "qwen2_0_5b"}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name)


def get(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.CONFIG


def get_reduced(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.REDUCED

