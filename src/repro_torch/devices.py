"""Where the port's entry points run: on the card, unless the caller asks
for the CPU."""
from __future__ import annotations

import torch

from repro_torch.kernels.packing import PackedWeight


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card. Raises
    RuntimeError when the card is asked for and there is none — the CPU
    runs only when the caller passes ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on an NVIDIA GPU; "
            "pass device='cpu' to run its plain PyTorch versions instead")
    return dev


def tree_to(tree, device: torch.device):
    """Move a parameter tree (nested dicts of tensors and PackedWeight
    leaves) to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (torch.Tensor, PackedWeight)):
        return tree.to(device)
    return tree
