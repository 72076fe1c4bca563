"""The port's dry run (``repro_torch.launch.dryrun``) and roofline
(``repro_torch.roofline.analyze``) on the CPU, in one process.

* Reduced dense and MoE cells (2 layers) of every kind (train, prefill,
  decode, latmix) run on the fake (16, 16) 256-rank mesh with ``status:
  ok``, and the prefill and decode cells on the (2, 16, 16) 512-rank mesh.
* A rank's argument bytes equal the sum of its shards by the rule table
  (global bytes over the sizes of the mesh axes in each leaf's spec).
* ``flops_per_device`` (local ops below DTensor) equals the global count
  divided as the shards say (each DTensor op's global FLOPs over the mesh
  sizes its output is split or partial over) within 1%.
* Roofline: ``_cache_bytes`` equals the JAX function for every family;
  the L1/L2 extrapolation equals the direct count at 4 layers; the
  model-FLOPs and decode-fraction formulas equal the JAX package's on the
  same counts.
"""
import dataclasses
import math
import os

import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as dr
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shardings as sh
from repro_torch.roofline import analyze as ra

torch.set_num_threads(1)

KINDS = ("train", "prefill", "decode", "latmix")
SEQ, BATCH = 32, 16


def _shape(kind):
    return ShapeConfig(f"t_{kind}", SEQ, BATCH, kind)


def _cfg(arch):
    """A reduced config cut to 2 layers (the cells' cost is per op)."""
    return dataclasses.replace(configs.get_reduced(arch), n_layers=2)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-moe-a2.7b"])
def test_pod_cells_run(arch, kind):
    rec = dr.run_counted(_cfg(arch), _shape(kind), False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_devices"] == 256
    assert rec["flops_per_device"] > 0
    assert rec["memory"]["peak_bytes"] > rec["memory"]["argument_bytes"]
    assert rec["collectives"], rec


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-moe-a2.7b"])
def test_multipod_cells_run(arch, kind):
    rec = dr.run_counted(_cfg(arch), _shape(kind), True)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_devices"] == 512


def _rule_bytes(args, shards, mesh):
    """A rank's bytes of ``args`` by the rule table: each leaf's global
    bytes over the product of its spec's mesh-axis sizes."""
    total = 0

    def add(t, s):
        nonlocal total
        if isinstance(t, torch.Tensor):
            div = 1
            for entry in s.spec:
                for ax in ((entry,) if isinstance(entry, str)
                           else entry or ()):
                    div *= mesh.shape[ax]
            total += t.numel() * t.element_size() // div
        return t
    for a, s in zip(args, shards):
        if s is not None:
            sh._zip_map(add, a, s)
    return total


class _GlobalFlops:
    """FLOPs seen at the DTensor level, each op's global count over the
    mesh sizes its output is split over (sharded, or partial from a split
    contraction — not partial because an input already was); ops on plain
    tensors (inside a local island) count as they are."""

    def __init__(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        me = self
        self.flops = 0.0

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                fn = flop_registry.get(func._overloadpacket)
                if fn is None or getattr(dr._quiet, "on", False):
                    return out
                f = float(fn(*args, **(kwargs or {}), out_val=out))
                if isinstance(out, DTensor):
                    ins = [a.placements for a in args
                           if isinstance(a, DTensor)]
                    for i, (size, p) in enumerate(zip(out.device_mesh.shape,
                                                      out.placements)):
                        # a partial output of whole-size local products
                        # (an input already partial there) is not split
                        if p.is_shard() or (p.is_partial() and not any(
                                q[i].is_partial() for q in ins)):
                            f /= size
                me.flops += f
                return out
        self.mode = Mode()


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_counts_follow_the_shards(kind):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import pcontext as pctx
    cfg, shape = _cfg("qwen2-0.5b"), _shape(kind)
    rec = dr.run_counted(cfg, shape, False)
    with mesh_lib.fake_world(256):
        mesh = mesh_lib.make_mesh((16, 16), ("data", "model"))
        step, args, shards, _ = dr.build_cell(cfg, shape, mesh, True,
                                              baked=True)
        assert rec["memory"]["argument_bytes"] == _rule_bytes(args, shards,
                                                              mesh)
        fake = FakeTensorMode(allow_non_fake_inputs=True)
        placed = dr.place(args, shards, fake)
        g = _GlobalFlops()
        seq = "model" if kind == "train" else None
        with fake, dr._dtensor_bookkeeping_uncounted(), g.mode, \
                pctx.activate(mesh, batch_axes=("data",), model_axis="model",
                              seq_axis=seq):
            step(*placed)
    assert g.flops > 0
    assert abs(rec["flops_per_device"] - g.flops) <= 0.01 * g.flops


def _jax_roofline():
    """The JAX package's roofline module, imported without letting its
    512-host-device XLA flag reach this process's later JAX use."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.roofline import analyze as jra
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jra


def test_cache_bytes_match_jax():
    from repro import configs as jconfigs
    jra = _jax_roofline()
    for arch in configs.ARCH_IDS:
        for B, S in ((128, 32768), (1, 524288), (4, 100)):
            assert ra._cache_bytes(configs.get(arch), B, S) == \
                jra._cache_bytes(jconfigs.get(arch), B, S), arch
        assert ra._variant_layers(configs.get(arch)) == \
            jra._variant_layers(jconfigs.get(arch))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-moe-a2.7b"])
def test_extrapolation_equals_the_direct_count(arch, monkeypatch):
    cfg = dataclasses.replace(configs.get_reduced(arch), n_layers=4)
    shape = ShapeConfig("t_four", SEQ, BATCH, "prefill")
    monkeypatch.setitem(ra.SHAPES, "t_four", shape)
    r = ra.analyze_cell(arch, "t_four", arch_cfg=cfg, baked=True)
    d = dr.run_counted(cfg, shape, False, True, baked=True,
                       mesh_shape=ra.MESH_SHAPE)
    assert r["units"] == 4
    assert r["flops_per_device"] == d["flops_per_device"]
    assert r["hbm_bytes_per_device"] == d["bytes_accessed_per_device"]
    assert r["collective_bytes_per_device"] == sum(
        v["bytes"] for v in d["collectives"].values())


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k",
                                        "long_500k"])
@pytest.mark.parametrize("arch", ["qwen2_7b", "qwen2_moe_a2_7b",
                                  "mamba2_130m", "recurrentgemma_2b"])
def test_roofline_formulas_match_jax(arch, shape_name, monkeypatch):
    """Both analyses fed the same per-variant counts give the same model
    FLOPs, useful ratio and (decode) roofline fraction."""
    from jax.sharding import AbstractMesh
    jra = _jax_roofline()
    counts = {}

    def fake_counts(L):
        return counts.setdefault(L, (1e12 * (L + 1), 3e9 * (L + 2),
                                     1e8 * L, {}))
    monkeypatch.setattr(jra, "_lower_variant", lambda cfg, *a, **k:
                        fake_counts(cfg.n_layers))
    monkeypatch.setattr(jra.mesh_lib, "make_production_mesh",
                        lambda **k: AbstractMesh((16, 16),
                                                 ("data", "model")))
    monkeypatch.setattr(ra, "_count_variant", lambda cfg, *a, **k:
                        fake_counts(cfg.n_layers) + (1,))
    want = jra.analyze_cell(arch, shape_name, baked=True)
    got = ra.analyze_cell(arch, shape_name, baked=True)
    assert want["status"] == got["status"]
    if want["status"] != "ok":
        return
    for k in ("model_flops", "useful_flops_ratio", "flops_per_device",
              "hbm_bytes_per_device", "collective_bytes_per_device",
              "units"):
        assert math.isclose(got[k], want[k], rel_tol=1e-12), k
    if shape_name != "prefill_32k":
        assert math.isclose(got["roofline_fraction"],
                            want["roofline_fraction"], rel_tol=1e-12)
    else:    # the compute-bound fraction follows each card's peaks
        assert math.isclose(got["roofline_fraction"] * ra.PEAK_FLOPS
                            * got["step_time_lower_bound_s"],
                            want["roofline_fraction"] * jra.PEAK_FLOPS
                            * want["step_time_lower_bound_s"],
                            rel_tol=1e-9)
