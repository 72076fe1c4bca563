"""Architecture config registry: ``get(name)`` / ``get_reduced(name)``.

The port carries every config of the JAX package: the dense transformers
(DeepSeek-67B, Qwen2-7B, Qwen2-0.5B, TinyLlama-1.1B), the hybrid
RecurrentGemma-2B, the MoE family (Moonlight-16B-A3B, Qwen1.5-MoE-A2.7B),
the encoder HuBERT-XLarge, the vlm InternVL2-26B and the ssm Mamba2-130M.
``ARCH_IDS`` lists them in the JAX package's order."""
from __future__ import annotations

import importlib

from .base import ArchConfig  # noqa

ARCH_IDS = [
    "deepseek_67b",
    "qwen2_7b",
    "qwen2_0_5b",
    "tinyllama_1_1b",
    "recurrentgemma_2b",
    "moonshot_v1_16b_a3b",
    "qwen2_moe_a2_7b",
    "hubert_xlarge",
    "internvl2_26b",
    "mamba2_130m",
]

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}
_ALIASES.update({
    "deepseek-67b": "deepseek_67b",
    "qwen2-7b": "qwen2_7b",
    "qwen2-0.5b": "qwen2_0_5b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "hubert-xlarge": "hubert_xlarge",
    "internvl2-26b": "internvl2_26b",
    "mamba2-130m": "mamba2_130m",
})


def canonical(name: str) -> str:
    return _ALIASES.get(name, name)


def get(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.CONFIG


def get_reduced(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.REDUCED


def all_configs():
    return {i: get(i) for i in ARCH_IDS}
