"""Lightweight partitioning context — ``repro.launch.pcontext`` over
DTensor placements.

Model code calls ``pctx.shard(x, "batch", None, "model")`` to annotate
activation layouts without threading a mesh through every signature.
Outside an active context (unit tests, single-device runs) the calls are
no-ops, and so they are on a tensor that is not a ``DTensor``. The launch
layer activates the context around a step:

    with pctx.activate(mesh, batch_axes=("pod", "data"), model_axis="model"):
        step(params, opt_state, batch)

Active, ``shard`` redistributes a ``DTensor`` to the placements the names
resolve to — the counterpart of ``with_sharding_constraint``. The context
also turns on DTensor's implicit replication, so plain tensors made inside
the model (positions, masks) combine with DTensors as replicated values.

Where a computation has no DTensor form, the model and layer call sites
run it as an island on local tensors: :func:`local` (laid out by logical
names), :func:`blockwise` (within MX / Hadamard blocks of the last axis)
or :func:`whole` (on whole tensors; the route the kernel wrappers take,
``kernels.ops.on_whole``).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

from repro_torch.kernels.ops import on_whole as whole


class _State:
    ctx = None


# process-wide, not per thread: autograd runs a CUDA backward — and with
# it the recomputed forward of an activation checkpoint — on the device's
# own thread, which must see the context the step was started under
_state = _State()


def _get():
    return _state.ctx


@contextlib.contextmanager
def activate(mesh, batch_axes: Sequence[str] = ("data",),
             model_axis: Optional[str] = "model",
             seq_axis: Optional[str] = None):
    """seq_axis: mesh axis for sequence parallelism — the residual stream
    carried between layers is sharded along sequence over this axis
    (training only), so saved-for-backward activations shrink by the TP
    degree; DTensor inserts the all-gather / reduce-scatter pair per layer
    (Megatron-SP)."""
    prev = _get()
    _state.ctx = {
        "mesh": mesh,
        "batch": tuple(batch_axes) if batch_axes else None,
        "model": model_axis,
        "seq": seq_axis,
    }
    try:
        if getattr(mesh, "device_mesh", None) is not None:
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _state.ctx = prev


def active() -> bool:
    return _get() is not None


def axis_size(axes) -> int:
    """The product of the active mesh's sizes of ``axes``."""
    from .shardings import _size
    return _size(_get()["mesh"], axes)


def is_dtensor(x) -> bool:
    """True for a ``DTensor`` (a value laid out over a mesh)."""
    if _get() is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def resolve(name) -> Optional[object]:
    """Map a logical axis name to mesh axes (or None)."""
    ctx = _get()
    if ctx is None or name is None:
        return None
    if name == "batch":
        return ctx["batch"]
    if name == "model":
        return ctx["model"]
    if name == "seq":
        return ctx.get("seq")
    return None


def spec(*names) -> tuple:
    """The mesh axes of each named dimension (a ``shardings.Spec``)."""
    from .shardings import Spec
    return Spec(*[resolve(n) for n in names])


def _guarded(shape, names, mesh):
    """The spec of ``names`` on a tensor of ``shape``, an axis dropped
    where it does not divide its dimension."""
    from .shardings import Spec, _div
    return Spec(*[_div(dim, resolve(n), mesh)
                  for dim, n in zip(shape, names)])


def local(fn, args, names, out_like=0):
    """``fn(*args)`` run on each rank's shards — the island where a
    computation is local by layout (attention over batch × heads, a
    capacity dispatch over batch) or where an op has no DTensor rule.
    Every ``DTensor`` argument is laid out as its entry of ``names`` (a
    tuple of logical names, one a dimension) resolves; a plain tensor
    argument with a names entry is taken as replicated and laid out so
    too (a per-lane vector, say); ``fn`` runs on the local tensors
    (``local_map``), and each tensor output comes back laid out as the
    argument ``out_like`` (one index, or one per output). Inactive, or
    with no ``DTensor`` argument, it is ``fn(*args)``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    ctx = _get()
    if ctx is None or not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    mesh = ctx["mesh"]
    from torch.distributed.tensor.experimental import local_map
    from .shardings import placements
    dm = mesh.device_mesh
    args = list(args)
    in_pl = []
    for i, (a, n) in enumerate(zip(args, names)):
        if n is None or not isinstance(a, torch.Tensor):
            in_pl.append(None)
            continue
        if not isinstance(a, DTensor):
            args[i] = DTensor.from_local(a, dm, [Replicate()] * dm.ndim,
                                         run_check=False)
        in_pl.append(list(placements(_guarded(a.shape, n, mesh), mesh)))
    # local_map: a list of placements an output; a tuple of them for many
    out_pl = (tuple(in_pl[i] for i in out_like)
              if isinstance(out_like, tuple) else in_pl[out_like])
    # a whole (replicated) input used by a computation split over a mesh
    # axis gets a partial sum of its gradient from each rank there
    split = {i for pl in in_pl if pl for i, q in enumerate(pl)
             if q.is_shard()}
    grad_pl = tuple(None if pl is None else
                    [Partial() if (q.is_replicate() and i in split) else q
                     for i, q in enumerate(pl)] for pl in in_pl)
    return local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=grad_pl, device_mesh=dm,
                     redistribute_inputs=True)(*args)


def _replicate_dims(x, drop, reduce_partial: bool = False):
    """``x`` with the mesh axes that split the dimensions ``drop(d)``
    selects made whole (a partial sum too, with ``reduce_partial``)."""
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if (p.is_shard() and drop(p.dim))
          or (reduce_partial and p.is_partial()) else p
          for p in x.placements]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def rows_whole(x):
    """``x`` (B, ..., K) ready for a projection: every axis between the
    batch and the last whole — the sequence-parallel all-gather (a
    (batch, seq)-split input would flatten into an interleaved layout) —
    and a partial sum (a row-parallel output) reduced."""
    if not is_dtensor(x):
        return x
    return _replicate_dims(x, lambda dim: 0 < dim % x.ndim < x.ndim - 1,
                           reduce_partial=True)


def blockwise(fn, x, block: int):
    """``fn(x)`` for a ``fn`` that acts within each ``block``-wide block of
    the last axis (an MX quantize, the T3 rotation): each rank runs it on
    its shard — the last axis gathered where a rank's share of it is not a
    whole number of blocks, a partial sum reduced — and the output keeps
    that layout."""
    from torch.distributed.tensor import DTensor
    if not is_dtensor(x):
        return fn(x)
    n, size = x.ndim, 1
    for ax, p in zip(x.device_mesh.shape, x.placements):
        if p.is_shard() and p.dim % n == n - 1:
            size *= ax
    split = size > 1 and (x.shape[-1] // size) % block != 0
    x = _replicate_dims(x, lambda d: split and d % n == n - 1,
                        reduce_partial=True)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements,
                              run_check=False)


class _Reshard(torch.autograd.Function):
    """``x`` laid out as ``want``; its gradient goes back laid out as
    ``x`` was, a partial sum as whole — not in whatever layout the op
    after it left the gradient in (DTensor cannot always take that back:
    splitting a split feature axis into heads, a sequence shard back into
    a partial sum)."""

    @staticmethod
    def forward(ctx, x, want):
        from torch.distributed.tensor import Replicate
        ctx.mesh = x.device_mesh
        ctx.src = [Replicate() if p.is_partial() else p for p in x.placements]
        if list(x.placements) == list(want):
            return x.view_as(x)
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.src), None


def grad_like(x):
    """``x`` as it is, its gradient laid out as ``x`` (see
    :class:`_Reshard`); a no-op outside a mesh."""
    if not is_dtensor(x):
        return x
    return _Reshard.apply(x, tuple(x.placements))


def shard(x, *names):
    """Redistribute ``x`` to the layout its logical names resolve to; a
    no-op when inactive or when ``x`` is not a ``DTensor``.
    Divisibility-guarded: axes that do not divide the dimension are dropped
    (e.g. batch=1 long-context decode, odd vocab sizes)."""
    if not is_dtensor(x):
        return x
    from .shardings import placements
    mesh = _get()["mesh"]
    want = placements(_guarded(x.shape, names, mesh), mesh)
    if tuple(x.placements) == want:
        return x
    return _Reshard.apply(x, want)
