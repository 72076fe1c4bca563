"""Rule-based parameter / batch / cache shardings — the port of
``repro.launch.shardings`` over DTensor placements.

Training: FSDP over "data" × TP over "model" (2D-sharded params; the
"pod" axis is pure DP — params are *not* sharded across pods, gradients
are all-reduced over it). Optimizer state mirrors the params (ZeRO-3).

Serving: TP over "model" only (weights resident per pod, batch over
data axes).

Every rule is divisibility-guarded: a dimension that the mesh axis does
not divide is left unsharded (e.g. batch=1 long-context, hubert's 504-way
head, mamba's 3352-wide in_proj output).

The rules return a :class:`Spec` of mesh-axis names, one entry a tensor
dimension — the counterpart of JAX's ``PartitionSpec``, comparable entry
by entry — and need only ``mesh.shape`` (name -> size), so they run
without a process group. :func:`placements` turns a spec into DTensor
placements over a mesh's ``DeviceMesh``; :func:`distribute` places a
tree (``jax.device_put``), :func:`gather` brings it back whole.

A ``PackedWeight`` (a packed MX serving weight) has no rule: its codes
and scales feed the packed GEMM kernel, which reads whole tiles, so it
stays whole on every rank (replicated) and :func:`distribute` leaves it
as it is.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.kernels.packing import PackedKV
from . import mesh as mesh_lib

# weight-name role sets (shared by all families; path's last dict key)
_COL = {"wq", "wk", "wv", "wg", "wu", "wx", "wy", "in_proj", "sg", "su"}
_ROW = {"wo", "wd", "wor", "out_proj", "sd"}
_EXP_COL = {"eg", "eu"}
_EXP_ROW = {"ed"}
_REPL = {"ln", "ln1", "ln2", "ln_f", "norm", "conv_b", "lam", "ga_w",
         "ga_b", "gx_w", "gx_b", "A_log", "D", "dt_bias", "perm", "sign"}
_BIAS = {"bq", "bk", "bv", "bo", "bg", "bu", "bd", "b_in", "b_out", "bx",
         "by", "bor", "brouter", "bhead", "beg", "beu", "bsg", "bsu"}


class Spec(tuple):
    """One entry per tensor dimension: None (whole), a mesh-axis name, or
    a tuple of names (the dimension split over their product, the first
    major) — ``PartitionSpec``'s meaning."""

    def __new__(cls, *entries):
        # a one-name tuple is that name, as PartitionSpec stores it
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``)."""
    mesh: object
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` over ``mesh``, one per mesh axis:
    ``Shard(d)`` where axis names dimension d, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for ax in mesh.axis_names:
        dim = None
        for d, entry in enumerate(spec):
            names = (entry,) if isinstance(entry, str) else (entry or ())
            if ax in names:
                dim = d
        out.append(Shard(dim) if dim is not None else Replicate())
    return tuple(out)


def _size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    return int(math.prod(mesh.shape[a] for a in axes))


def _div(dim: int, axes, mesh):
    """axes if it divides dim, else None (unsharded)."""
    if axes is None or dim <= 0:
        return None
    return axes if dim % _size(mesh, axes) == 0 else None


def param_spec(name: str, shape, cfg: ArchConfig, mode: str, mesh) -> Spec:
    fsdp = "data" if mode == "train" else None
    tp = "model"
    nd = len(shape)

    def lead(n_extra):  # leading stacked-layer axes
        return (None,) * (nd - n_extra)

    if name in _REPL:
        return Spec(*([None] * nd))
    if name in _BIAS:
        return Spec(*lead(1), _div(shape[-1], tp, mesh))
    if name == "conv_w":          # (L, C, K)
        return Spec(*lead(2), _div(shape[-2], tp, mesh), None)
    if name in _COL:              # (..., d_in, d_out)
        return Spec(*lead(2), _div(shape[-2], fsdp, mesh),
                    _div(shape[-1], tp, mesh))
    if name in _ROW:              # (..., d_in, d_out): d_in is the wide dim
        return Spec(*lead(2), _div(shape[-2], tp, mesh),
                    _div(shape[-1], fsdp, mesh))
    if name in _EXP_COL:          # (L, E, d, fe)
        if shape[-3] % _size(mesh, tp) == 0:   # expert parallel
            return Spec(*lead(3), tp, _div(shape[-2], fsdp, mesh), None)
        return Spec(*lead(3), None, _div(shape[-2], fsdp, mesh),
                    _div(shape[-1], tp, mesh))
    if name in _EXP_ROW:          # (L, E, fe, d)
        if shape[-3] % _size(mesh, tp) == 0:
            return Spec(*lead(3), tp, None, _div(shape[-1], fsdp, mesh))
        return Spec(*lead(3), None, _div(shape[-2], tp, mesh),
                    _div(shape[-1], fsdp, mesh))
    if name == "router":          # (L, d, E)
        return Spec(*lead(2), _div(shape[-2], fsdp, mesh), None)
    if name == "embed":           # (V, d)
        return Spec(_div(shape[0], tp, mesh), _div(shape[1], fsdp, mesh))
    if name == "head":            # (d, V)
        v_ax = _div(shape[1], tp, mesh)
        if v_ax is None:          # odd vocab: row-parallel fallback
            return Spec(_div(shape[0], tp, mesh), None)
        return Spec(_div(shape[0], fsdp, mesh), v_ax)
    if name in ("a", "v"):        # input_transform (d, d) / (d,)
        return Spec(*([None] * nd))
    # default: replicate
    return Spec(*([None] * nd))


def _map_named(fn, tree, name: str = ""):
    """``fn(name, leaf)`` over nested dicts (and named tuples), ``name``
    the nearest key (the JAX rules' leaf name). A ``PackedKV``'s codes
    and scales are named "0" and "1": in the JAX package they are its
    pytree children, whose index keys are the nearest keys — so the cache
    rules leave a packed cache whole, and ``shard_kv`` lays it out inside
    the step."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, PackedKV):
        return PackedKV(fn("0", tree.codes), fn("1", tree.scales),
                        tree.fmt, tree.dtype)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_named(fn, getattr(tree, f), name)
                            for f in tree._fields))
    return fn(name, tree)


def _packed(leaf) -> bool:
    from repro_torch.kernels.packing import PackedWeight
    return isinstance(leaf, PackedWeight)


def params_shardings(params, cfg: ArchConfig, mode: str, mesh):
    def visit(name, leaf):
        if _packed(leaf):
            return NamedSharding(mesh, Spec())
        return NamedSharding(mesh, param_spec(name, leaf.shape, cfg, mode,
                                              mesh))
    return _map_named(visit, params)


def opt_state_shardings(opt_state, params_sh, mesh):
    """AdamWState(step, m, v): m/v mirror the params."""
    from repro_torch.training.optimizer import AdamWState
    return AdamWState(step=NamedSharding(mesh, Spec()), m=params_sh,
                      v=dict(params_sh))


# ---------------------------------------------------------------------------
# Batch / cache shardings
# ---------------------------------------------------------------------------

def batch_spec(cfg: ArchConfig, batch: int, mesh):
    dp = mesh_lib.dp_axes(mesh)
    return _div(batch, dp, mesh)


def train_batch_shardings(cfg: ArchConfig, shape: ShapeConfig, mesh):
    dp = batch_spec(cfg, shape.global_batch, mesh)
    if cfg.embed_inputs:
        inputs = NamedSharding(mesh, Spec(dp, None))
    else:
        inputs = NamedSharding(mesh, Spec(dp, None, None))
    labels = NamedSharding(mesh, Spec(dp, None))
    return {"inputs": inputs, "labels": labels}


def cache_spec(name: str, shape, dp, mesh) -> Spec:
    tp = "model"
    sh = shape
    if name in ("k", "v"):            # (L, B, S, kd)
        return Spec(None, dp, None, _div(sh[-1], tp, mesh))
    if name in ("attn_k", "attn_v"):  # (ns, B, A, kd)
        return Spec(None, dp, None, _div(sh[-1], tp, mesh))
    if name == "rec_h":               # (ns, 2, B, lru)
        return Spec(None, None, dp, _div(sh[-1], tp, mesh))
    if name == "rec_conv":            # (ns, 2, B, lru, K-1)
        return Spec(None, None, dp, _div(sh[-2], tp, mesh), None)
    if name == "tail_h":              # (nt, B, lru)
        return Spec(None, dp, _div(sh[-1], tp, mesh))
    if name == "tail_conv":           # (nt, B, lru, K-1)
        return Spec(None, dp, _div(sh[-2], tp, mesh), None)
    if name == "ssm":                 # (L, B, H, P, N)
        return Spec(None, dp, None, None, _div(sh[-1], tp, mesh))
    if name == "conv":                # (L, B, conv_dim, K-1)
        return Spec(None, dp, _div(sh[-2], tp, mesh), None)
    return Spec(*([None] * len(sh)))


def cache_shardings(cache, cfg: ArchConfig, batch: int, mesh):
    """Shardings of a decode cache's leaves (a ``PackedKV``'s children
    stay whole, as in the JAX package: see :func:`_map_named`)."""
    dp = batch_spec(cfg, batch, mesh)
    return _map_named(
        lambda name, leaf: NamedSharding(
            mesh, cache_spec(name, leaf.shape, dp, mesh)), cache)


# ---------------------------------------------------------------------------
# Placing trees
# ---------------------------------------------------------------------------

def _zip_map(fn, tree, sh):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, tree[k], sh[k]) for k in tree}
    if isinstance(tree, PackedKV):
        return PackedKV(fn(tree.codes, sh.codes), fn(tree.scales, sh.scales),
                        tree.fmt, tree.dtype)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(fn, getattr(tree, f), getattr(sh, f))
                            for f in tree._fields))
    return fn(tree, sh)


def distribute_leaf(x, sharding: NamedSharding):
    """One tensor placed as ``sharding`` says (``distribute_tensor``: each
    rank keeps its shard of the whole tensor it is given); a ``PackedWeight``
    or a non-tensor (an optimizer step count) stays as it is."""
    if not isinstance(x, torch.Tensor):
        return x
    from torch.distributed.tensor import DTensor, distribute_tensor
    dm, pl = sharding.mesh.device_mesh, list(sharding.placements)
    if isinstance(x, DTensor):       # already laid out: reshard
        return x if list(x.placements) == pl else x.redistribute(dm, pl)
    # every rank holds the same whole tensor: each keeps its own shard
    # (no scatter from rank 0)
    out = distribute_tensor(x, dm, pl, src_data_rank=None)
    loc = out.to_local()
    if loc.untyped_storage().nbytes() > loc.numel() * loc.element_size():
        # a shard that is a view would keep the whole tensor alive
        out = DTensor.from_local(loc.clone(), dm, pl, run_check=False,
                                 shape=out.shape, stride=out.stride())
    return out


def distribute(tree, shardings):
    """``jax.device_put(tree, shardings)``: every tensor leaf becomes a
    ``DTensor`` of its sharding's placements."""
    return _zip_map(distribute_leaf, tree, shardings)


def gather(tree):
    """Every ``DTensor`` leaf as its whole tensor (``full_tensor()``);
    other leaves as they are."""
    from torch.distributed.tensor import DTensor

    def whole(name, x):
        return x.full_tensor() if isinstance(x, DTensor) else x
    return _map_named(whole, tree)
