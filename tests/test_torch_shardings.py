"""The port's parallel layouts (``repro_torch.launch.mesh`` / ``pcontext``
/ ``shardings`` / ``steps``) against the JAX package's, on the CPU in one
process.

* Rule-table parity: for every parameter and cache leaf of every family's
  reduced config, on meshes (2, 4), (4, 2), (16, 16) and (2, 16, 16), the
  port's ``param_spec`` / ``cache_shardings`` equal the JAX package's
  ``PartitionSpec`` entry by entry, in train and serve modes. Both sides
  get a device-free mesh (JAX's ``AbstractMesh``: only ``.shape`` is read).
* Abstract specs: ``abstract_params`` allocates nothing (DeepSeek-67B's
  tree, 134 GB in bf16, raises the RSS by under 200 MB) and holds
  ``cfg.param_count()`` elements; every family's tree has the JAX tree's
  paths and shapes; ``input_specs`` gives the JAX shapes and dtypes.
* ``pcontext`` resolves names as the JAX context does.
"""
import resource

import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.configs.base import ASSIGNED_SHAPES as J_SHAPES_ASSIGNED
from repro.configs.base import SHAPES as J_SHAPES
from repro.core.quantize import KVCacheQuant
from repro.launch import pcontext as jpctx
from repro.launch import shardings as jsh
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro_torch import configs
from repro_torch.configs.base import SHAPES
from repro_torch.kernels.packing import PackedKV
from repro_torch.launch import pcontext as pctx
from repro_torch.launch import shardings as sh
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.training import optimizer as opt

torch.set_num_threads(1)

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
FAMILIES = {"dense": "qwen2-0.5b", "moe": "qwen2-moe-a2.7b",
            "hybrid": "recurrentgemma-2b", "ssm": "mamba2-130m",
            "encoder": "hubert-xlarge", "vlm": "internvl2-26b"}


def _mesh(name):
    return AbstractMesh(*MESHES[name])


def _jax_leaves(tree):
    """(path, leaf name, shape) of a JAX abstract tree."""
    import jax
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out.append((key, jsh._leaf_name(path), tuple(leaf.shape)))
    return out


def _torch_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _torch_leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, PackedKV):
        yield prefix + "0", tree.codes
        yield prefix + "1", tree.scales
    else:
        yield prefix[:-1], tree


def _spec_tuple(p):
    return tuple(p)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_param_spec_parity(family):
    arch = FAMILIES[family]
    jtree = jsteps.abstract_params(jconfigs.get_reduced(arch))
    cfg = configs.get_reduced(arch)
    ttree = steps.abstract_params(cfg)
    jl = _jax_leaves(jtree)
    tl = dict(_torch_leaves(ttree))
    assert sorted(k for k, _, _ in jl) == sorted(tl)
    jcfg = jconfigs.get_reduced(arch)
    n = 0
    for mesh_name in MESHES:
        mesh = _mesh(mesh_name)
        for mode in ("train", "serve"):
            tsh = dict(_torch_leaves(
                sh.params_shardings(ttree, cfg, mode, mesh)))
            for key, name, shape in jl:
                assert tuple(tl[key].shape) == shape, key
                want = jsh.param_spec(name, shape, jcfg, mode, mesh)
                got = sh.param_spec(name, shape, cfg, mode, mesh)
                assert tuple(got) == _spec_tuple(want), (mesh_name, mode, key)
                assert tsh[key].spec == got
                n += 1
    assert n == len(jl) * len(MESHES) * 2


@pytest.mark.parametrize("family,kv", [
    (f, kv) for f in ("dense", "moe", "hybrid", "ssm", "vlm")
    for kv in ((None,) if f == "ssm" else (None, "mxfp8", "mxfp4"))])
def test_cache_shardings_parity(family, kv):
    import jax
    arch = FAMILIES[family]
    jcfg, cfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    jkq = KVCacheQuant.parse(kv) if kv else None
    for batch in (8, 6, 1):
        jcache = jax.eval_shape(lambda: japi.init_cache(
            jcfg, batch, 64, jnp.float32, kv_quant=jkq))
        tcache = api.init_cache(cfg, batch, 64, torch.float32,
                                kv_quant=jkq, device="meta")
        jl = _jax_leaves(jcache)
        tl = dict(_torch_leaves(tcache))
        assert sorted(k for k, _, _ in jl) == sorted(tl)
        for mesh_name in MESHES:
            mesh = _mesh(mesh_name)
            jsd = dict((k, s) for (k, _, _), s in zip(
                jl, jax.tree.leaves(jsh.cache_shardings(jcache, jcfg, batch,
                                                        mesh))))
            tsd = dict(_torch_leaves(
                sh.cache_shardings(tcache, cfg, batch, mesh)))
            for key, _, shape in jl:
                assert tuple(tl[key].shape) == shape
                assert tuple(tsd[key].spec) == tuple(jsd[key].spec), (
                    mesh_name, batch, key)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_shardings_parity(mesh_name):
    mesh = _mesh(mesh_name)
    for arch in ("qwen2-0.5b", "internvl2-26b"):
        jcfg, cfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
        for B in (256, 32, 6, 1):
            assert sh.batch_spec(cfg, B, mesh) == jsh.batch_spec(jcfg, B,
                                                                 mesh)
            shape = SHAPES["train_4k"].__class__("t", 64, B, "train")
            jshape = J_SHAPES["train_4k"].__class__("t", 64, B, "train")
            want = jsh.train_batch_shardings(jcfg, jshape, mesh)
            got = sh.train_batch_shardings(cfg, shape, mesh)
            for k in ("inputs", "labels"):
                assert tuple(got[k].spec) == tuple(want[k].spec)


def test_opt_state_mirrors_params():
    cfg = configs.get_reduced("qwen2-0.5b")
    mesh = _mesh("16x16")
    ap = steps.abstract_params(cfg)
    psh = sh.params_shardings(ap, cfg, "train", mesh)
    ost = sh.opt_state_shardings(steps.abstract_opt_state(cfg), psh, mesh)
    assert ost.step.spec == sh.Spec()
    assert ost.m == psh and ost.v == psh


def test_abstract_params_allocate_nothing():
    cfg = configs.get("deepseek_67b")
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    tree = steps.abstract_params(cfg)
    rise_mb = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
               - before) / 1024
    leaves = opt.tree_leaves(tree)
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) == cfg.param_count()
    assert sum(t.numel() * t.element_size() for t in leaves) > 130e9
    assert rise_mb < 200, rise_mb


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-moe-a2.7b",
                                  "recurrentgemma-2b", "mamba2-130m",
                                  "hubert-xlarge", "internvl2-26b"])
def test_abstract_params_match_jax_tree(arch):
    jl = _jax_leaves(jsteps.abstract_params(jconfigs.get(arch)))
    tl = dict(_torch_leaves(steps.abstract_params(configs.get(arch))))
    assert {k: s for k, _, s in jl} == {k: tuple(t.shape)
                                        for k, t in tl.items()}


_DT = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.float32):
       torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16}


@pytest.mark.parametrize("shape_name", list(J_SHAPES_ASSIGNED))
def test_input_specs_match_jax(shape_name):
    import jax
    for arch in ("qwen2-0.5b", "recurrentgemma-2b", "mamba2-130m",
                 "internvl2-26b"):
        jcfg, cfg = jconfigs.get(arch), configs.get(arch)
        want = jsteps.input_specs(jcfg, J_SHAPES[shape_name])
        got = steps.input_specs(cfg, SHAPES[shape_name])
        jleaves = [(tuple(l.shape), _DT[jnp.dtype(l.dtype)])
                   for l in jax.tree.leaves(want)]
        tleaves = [(tuple(t.shape), t.dtype) for _, t in _torch_leaves(got)]
        assert sorted(jleaves, key=str) == sorted(tleaves, key=str), arch
        assert all(t.device.type == "meta" for _, t in _torch_leaves(got))


def test_pcontext_resolves_as_jax():
    mesh = _mesh("2x16x16")
    assert not pctx.active()
    x = torch.ones(4, 4)
    assert pctx.shard(x, "batch", "model") is x
    kw = dict(batch_axes=("pod", "data"), model_axis="model",
              seq_axis="model")
    with pctx.activate(mesh, **kw), jpctx.activate(mesh, **kw):
        assert pctx.active()
        for names in [("batch", None, "model"), ("batch", "seq", None),
                      (None, "model"), ("other",)]:
            assert tuple(pctx.spec(*names)) == tuple(jpctx.spec(*names))
        assert pctx.shard(x, "batch", "model") is x   # not a DTensor
    assert not pctx.active()


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    class M:
        axis_names = ("pod", "data", "model")
        shape = {"pod": 2, "data": 16, "model": 16}
    assert sh.placements(sh.Spec(("pod", "data"), None, "model"), M) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.placements(sh.Spec(None, None), M) == (Replicate(),) * 3
    assert sh.Spec(("data",), None) == ("data", None)
