"""Parameter trees (and transform sets) from the JAX package's layout to
the port's.

The JAX package keeps parameters as nested dicts of arrays with
layer-stacked leaves, and packed weights as ``PackedWeight`` nodes; the port
keeps the same tree with torch tensors and its own ``PackedWeight``. Both
packages then compute on the same weights, byte for byte.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import devices
from repro_torch.core.folding import TransformSet
from repro_torch.kernels.packing import PackedWeight


def params_from_numpy(tree, device=None):
    """Nested dict of numpy arrays -> the port's parameter tree on
    ``device`` (the card unless the caller names another). A packed weight
    arrives as an object or dict carrying ``codes_packed`` and
    ``scales_e8m0`` arrays (and optionally ``fmt`` / ``dtype``) and becomes
    a ``PackedWeight``; every other leaf becomes a tensor of its own
    dtype."""
    device = devices.resolve(device)
    if isinstance(tree, dict) and "codes_packed" not in tree:
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    get = tree.get if isinstance(tree, dict) else (
        lambda k, d=None: getattr(tree, k, d))
    if get("codes_packed") is not None:
        return PackedWeight(
            torch.from_numpy(np.array(get("codes_packed"), np.uint8)).to(device),
            torch.from_numpy(np.array(get("scales_e8m0"), np.uint8)).to(device),
            str(get("fmt", "mxfp4")), str(get("dtype", "float32")))
    return torch.from_numpy(np.array(tree)).to(device)


def tset_from_numpy(tset, device=None):
    """A JAX ``TransformSet`` (or a dict with the same fields: ``a1``,
    ``v1``, ``a2``, ``v2``, ``t3_block``) -> the port's, its arrays as
    float32 tensors on ``device`` (the card unless the caller names
    another)."""
    device = devices.resolve(device)
    get = tset.get if isinstance(tset, dict) else (
        lambda k: getattr(tset, k))

    def arr(k):
        a = get(k)
        return None if a is None else torch.from_numpy(
            np.array(a, np.float32)).to(device)

    return TransformSet(a1=arr("a1"), v1=arr("v1"), a2=arr("a2"),
                        v2=arr("v2"), t3_block=int(get("t3_block")))
