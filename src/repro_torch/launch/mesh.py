"""Meshes of the port — ``repro.launch.mesh`` over
``torch.distributed.device_mesh.DeviceMesh``.

Functions (never module-level constants), so importing this module starts
no process group. Single pod: 16×16 = 256 ranks, ("data", "model").
Multi-pod: 2×16×16 = 512 ranks with a leading pure-DP "pod" axis. These
are the JAX package's shapes, so per-rank shards compare cell by cell; the
port runs them on the ``"fake"`` backend (the dry run) or over as many
ranks as the process group has.

:func:`init_distributed` starts the process group: ``env://`` (torchrun),
``tcp://host:port`` with a world size and a rank (the ``--coordinator``
flags), a ``torch.distributed.Store`` (tests: a ``FileStore``), or
``"fake"`` (one process standing for ``world_size`` ranks, collectives
no-ops). The mesh's device type is ``cuda`` over NCCL, ``cpu`` over gloo
or the fake backend.
"""
from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist


class Mesh:
    """A named mesh: ``shape`` maps axis name -> size (JAX's
    ``Mesh.shape``), so the rule functions need only that; ``device_mesh``
    is the ``DeviceMesh`` the DTensors live on."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.shape))

    @property
    def device_type(self) -> str:
        return self.device_mesh.device_type

    def __repr__(self):
        return f"Mesh({self.shape}, {self.device_type!r})"


_device_type = {"type": "cpu"}


def init_distributed(init: str = "env://", *, world_size: int | None = None,
                     rank: int | None = None, store=None,
                     device: str | None = None) -> str:
    """Start the default process group; returns the meshes' device type.

    ``init``: ``"env://"`` (torchrun's RANK / WORLD_SIZE / MASTER_ADDR),
    ``"tcp://host:port"`` (give ``world_size`` and ``rank``), or
    ``"fake"`` (``world_size`` ranks in this one process). ``store`` (a
    ``torch.distributed.Store``, e.g. a ``FileStore``) replaces ``init``.
    ``device`` "cuda" (or None) runs NCCL on the card ``rank %
    device_count`` and raises where there is none; "cpu" runs gloo — the
    CPU only when the caller asks for it, as ``devices.resolve`` has it."""
    if init == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=int(world_size))
        _device_type["type"] = "cpu"
        return "cpu"
    from repro_torch import devices
    device = devices.resolve(device).type
    kw = {}
    if device == "cuda":
        backend = "nccl"
        r = rank if rank is not None else int(os.environ.get("RANK", "0"))
        local = int(os.environ.get("LOCAL_RANK", r))
        local %= torch.cuda.device_count()
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    else:
        backend = "gloo"
    if store is not None:
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size, **kw)
    elif init == "env://":
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world_size, **kw)
    _device_type["type"] = device
    return device


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks for the span of the
    block (the dry run); an existing default group is refused."""
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already running")
    init_distributed("fake", world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape, axes) -> Mesh:
    """A mesh of ``shape`` over the running process group's ranks, its
    axes named ``axes``."""
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(_device_type["type"], tuple(shape),
                          mesh_dim_names=tuple(axes))
    return Mesh(dm)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """Small mesh over the process group's ranks (tests)."""
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, n // data)
    return make_mesh((data, model), ("data", "model"))


def dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def model_axis(mesh):
    return "model" if "model" in mesh.shape else None
