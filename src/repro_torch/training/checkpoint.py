"""Fault-tolerant checkpoints — the port of ``repro.training.checkpoint``,
in its on-disk format, so a checkpoint written by either package restores
in the other:

  * ``step_%08d/`` holds ``arrays.npz`` (one array a leaf, under the JAX
    package's flattened key names: dict keys joined by ``/``, a named
    tuple's field as ``.name``, a list index as ``[i]`` — so an
    ``AdamWState`` is ``opt/.step``, ``opt/.m/...``, ``opt/.v/...``) and
    ``manifest.json`` (step, time, keys, shapes, dtypes, extra);
  * atomic writes: a temp directory, then ``os.replace``;
  * keep-last-N retention, monotonically numbered steps, resume through
    :func:`latest_step`.

bfloat16 leaves are stored as the JAX package stores them (numpy has no
bfloat16: two raw bytes a value, ``|V2``, with ``"bfloat16"`` in the
manifest) and read back from those bytes.

Storage is mesh-independent: a ``DTensor`` leaf (a tree laid out over a
mesh) is saved whole (``full_tensor()``, a collective every rank joins;
rank 0 writes), and ``restore(..., shardings=)`` places each leaf by
``distribute_tensor`` — the elastic path: any mesh whose axes divide the
dimensions reloads a checkpoint of any other, or of none.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import devices


def _paths(tree, prefix: str = ""):
    """(key, leaf) pairs of ``tree`` in ``jax.tree_util``'s order: dicts
    by sorted key, named tuples and lists by position."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _paths(getattr(tree, f), f"{prefix}.{f}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}[{i}]/")
    elif tree is not None:
        yield prefix[:-1], tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if type(leaf).__name__ == "DTensor":
            leaf = leaf.full_tensor()
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)   # an optimizer step count
    return np.asarray(leaf)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def save(ckpt_dir, step: int, tree: Any, keep: int = 3,
         extra: Optional[dict] = None) -> pathlib.Path:
    """Atomically persist ``tree`` (nested dicts, named tuples, tensors,
    ints) as checkpoint ``step``; keep the newest ``keep``."""
    root = pathlib.Path(ckpt_dir)
    flat, dtypes = {}, {}
    for key, leaf in _paths(tree):
        flat[key] = _to_numpy(leaf)
        dtypes[key] = _dtype_name(leaf, flat[key])
    final = root / f"step_{step:08d}"
    if _rank() != 0:                  # rank 0 writes the whole tensors
        _barrier()
        return final
    root.mkdir(parents=True, exist_ok=True)
    tmp = root / f".tmp_step_{step}_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    np.savez(tmp / "arrays.npz", **flat)
    manifest = {
        "step": step,
        "time": time.time(),
        "keys": sorted(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": dtypes,
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)            # atomic on POSIX
    _retain(root, keep)
    _barrier()
    return final


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def _barrier() -> None:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def _retain(root: pathlib.Path, keep: int):
    steps = sorted(p for p in root.iterdir()
                   if p.is_dir() and p.name.startswith("step_"))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir) -> Optional[int]:
    root = pathlib.Path(ckpt_dir)
    if not root.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in root.iterdir()
             if p.is_dir() and p.name.startswith("step_")
             and (p / "manifest.json").exists()]
    return max(steps) if steps else None


def _from_numpy(arr: np.ndarray, stored: str, like, device):
    """A stored array as a leaf of ``like``'s kind: a tensor of its dtype
    on ``device``, or an int for an int leaf (an optimizer step)."""
    if isinstance(like, int):
        return int(arr)
    if stored == "bfloat16" or arr.dtype.kind == "V":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=device, dtype=like.dtype)


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), it)
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    if tree is None:
        return None
    return next(it)


def restore(ckpt_dir, tree_like: Any, step: Optional[int] = None,
            device=None, shardings: Any = None) -> tuple:
    """Load checkpoint ``step`` (default: the latest) into the structure
    of ``tree_like`` (tensors give the dtype of each leaf; ``None``
    subtrees are skipped). Leaves land on ``device`` (None: the card).
    ``shardings`` (a matching tree of ``launch.shardings.NamedSharding``)
    places each leaf as a DTensor by ``distribute_tensor`` as it is read,
    from the host, so one whole leaf at most reaches the device — the
    elastic reload. Returns (tree, manifest)."""
    dev = devices.resolve(device)
    shards = {}
    if shardings is not None:
        from repro_torch.launch.shardings import distribute_leaf
        shards, dev = dict(_paths(shardings)), torch.device("cpu")
    root = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = root / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    out = []
    with np.load(d / "arrays.npz") as arrays:
        for key, leaf in _paths(tree_like):
            arr = arrays[key]
            shape = [] if isinstance(leaf, int) else list(leaf.shape)
            if list(arr.shape) != shape:
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {tuple(shape)}")
            t = _from_numpy(arr, manifest["dtypes"].get(key, ""), leaf, dev)
            out.append(distribute_leaf(t, shards[key]) if shards else t)
    return _rebuild(tree_like, iter(out)), manifest
