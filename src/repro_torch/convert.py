"""Parameter trees, AdamW states and transform sets from the JAX
package's layout to the port's.

The JAX package keeps parameters as nested dicts of arrays with
layer-stacked leaves, and packed weights as ``PackedWeight`` nodes; the port
keeps the same tree with torch tensors and its own ``PackedWeight``. Both
packages then compute on the same weights, byte for byte. This covers every
family: a vlm's or encoder's tree has no ``embed`` and, after the PTQ fold,
an ``input_transform`` ({"a", "v"}) subtree; Griffin's holds ``super/{r1,
r2, at}`` stacked over the super-blocks and ``tail``, Mamba2's ``blocks``,
and a hybrid ``TransformSet`` stacks ``a2`` over the super-blocks'
attention layers. bfloat16 leaves
(numpy arrays of ``ml_dtypes.bfloat16``, as JAX hands them out) keep their
bits. A checkpoint on disk needs no conversion: ``training.checkpoint``
reads the JAX package's format.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import devices
from repro_torch.core.folding import TransformSet
from repro_torch.kernels.packing import PackedWeight
from repro_torch.training.optimizer import AdamWState


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
    return _tensor(tree).to(device)


def _tensor(a) -> torch.Tensor:
    arr = np.array(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def opt_state_from_numpy(state, device=None) -> AdamWState:
    """A JAX ``AdamWState`` (or a dict with ``step``, ``m``, ``v``) -> the
    port's: ``step`` an int, ``m`` and ``v`` float32 trees on ``device``
    (the card unless the caller names another), so a JAX optimizer state
    resumes in the port's trainer."""
    get = state.get if isinstance(state, dict) else (
        lambda k: getattr(state, k))
    return AdamWState(step=int(np.asarray(get("step"))),
                      m=params_from_numpy(get("m"), device),
                      v=params_from_numpy(get("v"), device))


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
