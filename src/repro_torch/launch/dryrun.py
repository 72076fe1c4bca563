"""Multi-pod dry run of the port: every (architecture × input shape × mesh)
cell's step run once over abstract inputs on the production meshes.

  single pod : (16, 16)    ("data", "model")        256 ranks
  multi-pod  : (2, 16, 16) ("pod", "data", "model") 512 ranks

The port cannot lower and compile a step as XLA does, so it runs it: a
``"fake"`` process group stands for the 256 or 512 ranks in one process,
``FakeTensorMode`` gives every tensor its shape and no storage, and the
parameters, optimizer state, inputs and cache are ``DTensor``\\ s laid out
by ``shardings`` (each rank's local shard a fake tensor). The step —
``train_step``, ``prefill_step``, ``serve_step`` or ``latmix_step``, as
:func:`build_cell` picks it — runs under ``pctx.activate``, and a dispatch
mode below DTensor sees every local op and collective of one rank:

  · ``memory``: ``argument_bytes`` (this rank's shards of params, optimizer
    state and inputs), ``output_bytes`` (its shards of the step's outputs),
    ``temp_bytes`` (the most bytes the step's own tensors held at once,
    alive storages counted once) and ``peak_bytes`` (their sum with the
    arguments: what the rank's memory must hold);
  · ``flops_per_device``: the FLOPs of the local matmul / attention ops
    (``torch.utils.flop_counter``'s formulas on the local shapes);
  · ``bytes_accessed_per_device``: each local op's input and output bytes
    summed (views excluded) — the port's unfused eager traffic, an upper
    bound of what a fused program moves, not XLA's fused count;
  · ``collectives``: count and bytes (of each call's local output) by kind
    — all-reduce, all-gather, reduce-scatter, all-to-all — from the
    ``c10d_functional`` ops DTensor issues (on CPU groups DTensor runs an
    all-to-all as all-gather + chunk, and the count shows that).

These are analysis, not measurement: nothing runs on a device. Records go
to experiments/dryrun_torch/<arch>__<shape>__<mesh>.json and feed the
roofline (``repro_torch.roofline.analyze``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both [--no-quant] [--accum auto]
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import pathlib
import threading
import time
import traceback
import weakref

import torch

from repro_torch import configs
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.core.quantize import QuantMode
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import pcontext as pctx
from repro_torch.launch import shardings as sh
from repro_torch.launch import steps as steps_lib
from repro_torch.training import optimizer as opt

# per-arch gradient-accumulation defaults (the JAX package's)
ACCUM = {
    "deepseek_67b": 4, "internvl2_26b": 16, "qwen2_7b": 4,
    "moonshot_v1_16b_a3b": 4, "qwen2_moe_a2_7b": 2, "recurrentgemma_2b": 2,
    "hubert_xlarge": 2, "tinyllama_1_1b": 2, "qwen2_0_5b": 1,
    "mamba2_130m": 1,
}

_KINDS = (("all_reduce", "all-reduce"), ("all_gather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"),
          ("broadcast", "broadcast"))


def accum_for(cfg, shape, dp_total: int, accum: str = "auto") -> int:
    """The microbatch count of a train cell: ACCUM's (or ``accum``),
    halved until it divides the batch into per-rank-divisible parts."""
    n_acc = (ACCUM.get(cfg.name.replace("-", "_").replace(".", "_"), 1)
             if accum == "auto" else int(accum))
    per_dev = max(1, shape.global_batch // dp_total)
    while n_acc > 1 and (shape.global_batch % n_acc
                         or (shape.global_batch // n_acc) % dp_total):
        n_acc //= 2
    return min(n_acc, per_dev)


def build_cell(cfg, shape, mesh, quant: bool, accum: str = "auto",
               baked: bool = False):
    """Returns (step_fn, args, shardings, extra): ``args`` abstract (meta)
    trees, ``shardings`` the matching trees of ``NamedSharding`` (None for
    a non-tensor argument), ready for :func:`place`.

    baked=True serves with pre-quantized weights (the deployable path:
    only activations are quantized in the step); baked=False re-quantizes
    the weights inside the step (the naive baseline)."""
    dp_total = 1
    for a in mesh_lib.dp_axes(mesh):
        dp_total *= mesh.shape[a]
    aparams = steps_lib.abstract_params(cfg)
    mode = "train" if shape.kind == "train" else "serve"
    psh = sh.params_shardings(aparams, cfg, mode, mesh)
    specs = steps_lib.input_specs(cfg, shape)
    if quant and shape.kind not in ("train", "latmix"):
        qm = QuantMode.mxfp4(weights=not baked)
    else:
        qm = QuantMode.off()
    B = shape.global_batch
    dp = sh.batch_spec(cfg, B, mesh)

    def along_batch(t):
        return sh.NamedSharding(mesh, sh.Spec(dp, *([None] * (t.ndim - 1))))

    if shape.kind == "train":
        n_acc = accum_for(cfg, shape, dp_total, accum)
        step = steps_lib.make_train_step(cfg, opt.AdamWConfig(),
                                         accum=n_acc)
        ost = steps_lib.abstract_opt_state(cfg)
        osh = sh.opt_state_shardings(ost, psh, mesh)
        bsh = sh.train_batch_shardings(cfg, shape, mesh)
        return (step, (aparams, ost, specs["batch"]), (psh, osh, bsh),
                {"accum": n_acc})

    if shape.kind == "prefill":
        step = steps_lib.make_prefill_step(cfg, qm)
        return (step, (aparams, specs["inputs"]),
                (psh, along_batch(specs["inputs"])), {})

    if shape.kind == "latmix":
        # the paper's own workload: one distributed transform-learning step
        from repro_torch.core import latmix as lx_lib
        from repro_torch.core import prng
        lx = lx_lib.LatmixConfig(kind="lu", steps=100)
        step = steps_lib.make_latmix_step(cfg, lx)
        # Ω's init factorizes its matrices on the host: build it once,
        # concretely, and keep only the shapes
        omega = lx_lib.init_omega(prng.prng_key(0, "cpu"), cfg, lx)
        meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
        learn = opt.tree_map(meta, {k: v["learn"] for k, v in omega.items()})
        fixed = opt.tree_map(meta, {k: v["fixed"] for k, v in omega.items()})
        del omega
        ost = opt.init_state(learn)
        S = shape.seq_len
        batch = {"inputs": torch.empty((B, S), dtype=torch.int32,
                                       device="meta"),
                 "labels": torch.empty((B, S), dtype=torch.int32,
                                       device="meta")}
        teacher = torch.empty((B, S, cfg.vocab_size),
                              dtype=steps_lib.param_dtype(cfg),
                              device="meta")
        rep = lambda t: sh.NamedSharding(mesh, sh.Spec())
        bsh = sh.train_batch_shardings(cfg, shape, mesh)
        return (step, (aparams, learn, fixed, ost, batch, teacher),
                (psh, opt.tree_map(rep, learn), opt.tree_map(rep, fixed),
                 sh._map_named(lambda n, t: rep(t), ost), bsh,
                 along_batch(teacher)), {})

    # decode: one new token against a cache of seq_len, the last row
    step = steps_lib.make_serve_step(cfg, qm)
    csh = sh.cache_shardings(specs["cache"], cfg, B, mesh)
    return (step, (aparams, specs["cache"], specs["inputs"],
                   shape.seq_len - 1),
            (psh, csh, along_batch(specs["inputs"]), None), {})


def _fake_shard(meta, sharding, fake_mode):
    """A meta tensor as a DTensor of ``sharding``'s placements whose local
    shard is a fake tensor (no storage)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(meta, torch.Tensor):
        return meta
    pl = list(sharding.placements)
    shape = list(meta.shape)
    for ax, p in zip(sharding.mesh.axis_names, pl):
        if p.is_shard():
            shape[p.dim] //= sharding.mesh.shape[ax]
    with fake_mode:
        local = torch.empty(shape, dtype=meta.dtype, device="cpu")
        return DTensor.from_local(local, sharding.mesh.device_mesh, pl,
                                  run_check=False, shape=meta.shape,
                                  stride=_contiguous_stride(meta.shape))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(list(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def place(args, shardings, fake_mode):
    """Every abstract argument as fake DTensors laid out as its sharding
    says (a non-tensor argument passes as it is)."""
    out = []
    for a, s in zip(args, shardings):
        if s is None:
            out.append(a)
        else:
            out.append(sh._zip_map(
                lambda t, shd: _fake_shard(t, shd, fake_mode), a, s))
    return tuple(out)


# ---------------------------------------------------------------------------
# Counting one rank's local work
# ---------------------------------------------------------------------------

_quiet = threading.local()


def _uncounted(fn, real: bool = False):
    """``fn`` with its tensor ops left out of the counts; ``real`` runs
    them on real tensors (outside ``FakeTensorMode``)."""
    def quiet(*a, **k):
        prev = getattr(_quiet, "on", False)
        _quiet.on = True
        try:
            if real:
                from torch._subclasses.fake_tensor import (
                    unset_fake_temporarily)
                with unset_fake_temporarily():
                    return fn(*a, **k)
            return fn(*a, **k)
        finally:
            _quiet.on = prev
    return quiet


@contextlib.contextmanager
def _dtensor_bookkeeping_uncounted():
    """DTensor works out each op's output shape by running it on fake
    global tensors, and a strided layout's local offsets from small index
    tensors it reads back (which a fake tensor cannot give): neither is
    work of a rank's, so both stay out of the counts, the second on real
    tensors."""
    from torch.distributed.tensor import _utils
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    patches = [(ShardingPropagator, "_propagate_tensor_meta_non_cached",
                False),
               (_utils, "_compute_local_shape_and_global_offset", True)]
    saved = [(o, n, getattr(o, n)) for o, n, _ in patches if hasattr(o, n)]
    for (o, n, real), (_, _, fn) in zip(
            [p for p in patches if hasattr(p[0], p[1])], saved):
        setattr(o, n, _uncounted(fn, real))
    try:
        yield
    finally:
        for o, n, fn in saved:
            setattr(o, n, fn)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class LocalCounter:
    """A dispatch mode below DTensor (it declines DTensor-level calls, so
    DTensor dispatches them and calls back with the local tensors): FLOPs,
    bytes, collectives and live storage of one rank."""

    def __init__(self, known=()):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        counter = self
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives = {}
        self.live = 0
        self.peak = 0
        self._seen = set()
        self._flop = flop_registry
        for t in known:
            self._seen.add(self._key(t))

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch.distributed.tensor import DTensor
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **(kwargs or {}))
                if not getattr(_quiet, "on", False):
                    counter._count(func, args, kwargs or {}, out)
                return out
        self.mode = Mode()

    @staticmethod
    def _key(t):
        try:
            return t.untyped_storage()._cdata
        except Exception:    # noqa: BLE001 — a tensor without storage
            return None

    def _track(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)

        def gone(key=key, n=n, counter=weakref.ref(self)):
            c = counter()
            if c is not None:
                c.live -= n
                c._seen.discard(key)
        weakref.finalize(st, gone)

    def _count(self, func, args, kwargs, out):
        name = func.name()
        outs = list(_tensors(out))
        for t in outs:
            self._track(t)
        if name.startswith("_c10d_functional"):
            for frag, kind in _KINDS:
                if frag in name:
                    e = self.collectives.setdefault(kind,
                                                    {"count": 0, "bytes": 0})
                    e["count"] += 1
                    e["bytes"] += sum(_nbytes(t) for t in outs)
            return
        if name.startswith("prim::"):
            return
        fn = self._flop.get(func._overloadpacket)
        if fn is not None:
            self.flops += float(fn(*args, **kwargs, out_val=out))
        rets = func._schema.returns
        if rets and rets[0].alias_info is not None and \
                not rets[0].alias_info.is_write:
            return                      # a view moves nothing
        self.bytes += sum(_nbytes(t) for t in _tensors(args))
        self.bytes += sum(_nbytes(t) for t in outs)


def _local_leaves(tree):
    from torch.distributed.tensor import DTensor
    for t in _tensors(_as_plain(tree)):
        yield t._local_tensor if isinstance(t, DTensor) else t


def _as_plain(tree):
    """Nested containers of a tree (named tuples, PackedKV) as lists."""
    from repro_torch.kernels.packing import PackedKV
    if isinstance(tree, dict):
        return [_as_plain(v) for v in tree.values()]
    if isinstance(tree, PackedKV):
        return [tree.codes, tree.scales]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [_as_plain(getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [_as_plain(v) for v in tree]
    return tree


def count_step(step, placed, mesh, seq_axis=None) -> dict:
    """Run ``step(*placed)`` once under the mesh's context, counting this
    rank's local work (see the module doc)."""
    arg_locals = list(_local_leaves(placed))
    counter = LocalCounter(known=arg_locals)
    with _dtensor_bookkeeping_uncounted(), counter.mode, \
            pctx.activate(mesh, batch_axes=mesh_lib.dp_axes(mesh),
                          model_axis="model", seq_axis=seq_axis):
        out = step(*placed)
    out_locals = list(_local_leaves(out))
    return {"flops": counter.flops, "bytes": counter.bytes,
            "collectives": counter.collectives,
            "argument_bytes": sum(_nbytes(t) for t in arg_locals),
            "output_bytes": sum(_nbytes(t) for t in out_locals),
            "temp_bytes": counter.peak}


def run_cell(arch: str, shape_name: str, multi_pod: bool, quant: bool,
             outdir: pathlib.Path, accum: str = "auto", arch_cfg=None,
             baked: bool = True, write: bool = True) -> dict:
    cfg = arch_cfg or configs.get(arch)
    shape = SHAPES[shape_name]
    mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "family": cfg.family,
           "quant": bool(quant and shape.kind not in ("train", "latmix"))}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
    else:
        rec.update(run_counted(cfg, shape, multi_pod, quant, accum, baked))
    if write:
        outdir.mkdir(parents=True, exist_ok=True)
        (outdir / f"{arch}__{shape_name}__{mesh_name}.json").write_text(
            json.dumps(rec, indent=1))
    return rec


def run_counted(cfg, shape, multi_pod: bool, quant: bool = True,
                accum: str = "auto", baked: bool = True,
                mesh_shape=None) -> dict:
    """One cell's record on a fake group (the production mesh, or
    ``mesh_shape`` — a (data, model) shape — for a smaller one)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    if mesh_shape is not None:
        n = mesh_shape[0] * mesh_shape[1]
    else:
        n = 512 if multi_pod else 256
    t0 = time.time()
    rec = {}
    try:
        with mesh_lib.fake_world(n):
            mesh = (mesh_lib.make_mesh(mesh_shape, ("data", "model"))
                    if mesh_shape is not None else
                    mesh_lib.make_production_mesh(multi_pod=multi_pod))
            step, args, shards, extra = build_cell(cfg, shape, mesh, quant,
                                                   accum, baked=baked)
            rec.update(extra)
            fake = FakeTensorMode(allow_non_fake_inputs=True)
            placed = place(args, shards, fake)
            seq_ax = "model" if shape.kind == "train" else None
            with fake:
                c = count_step(step, placed, mesh, seq_axis=seq_ax)
        rec.update({
            "status": "ok",
            "run_s": round(time.time() - t0, 1),
            "flops_per_device": c["flops"],
            "bytes_accessed_per_device": c["bytes"],
            "memory": {"argument_bytes": c["argument_bytes"],
                       "output_bytes": c["output_bytes"],
                       "temp_bytes": c["temp_bytes"],
                       "peak_bytes": c["argument_bytes"]
                       + c["temp_bytes"]},
            "collectives": c["collectives"],
            "n_devices": n,
            "param_count": cfg.param_count(),
            "param_count_active": cfg.param_count(active_only=True),
        })
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return rec


def _cost(cell) -> int:
    """A cell's rough cost (the run's op count grows with the depth and
    the sequence): the grid runs the cheap cells first."""
    cfg = configs.get(cell[0])
    return cfg.n_layers * min(SHAPES[cell[1]].seq_len, 32768)


def _grid_cell(arch, shape_name, multi_pod, *, quant, outdir, accum,
               reduced, baked):
    cfg = (configs.get_reduced if reduced else configs.get)(arch)
    return run_cell(arch, shape_name, multi_pod, quant, outdir, accum,
                    arch_cfg=cfg, baked=baked)


def _timed(fn, cell):
    t0 = time.time()
    return (*cell, fn(*cell), time.time() - t0)


def _cells(cells, jobs: int, fn):
    """(cell..., fn(*cell), seconds) for each cell — in this process, or
    over ``jobs`` fresh processes (each cell's fake group its own), in the
    order they finish."""
    if jobs <= 1:
        for cell in cells:
            yield _timed(fn, cell)
        return
    import concurrent.futures as cf
    import multiprocessing
    with cf.ProcessPoolExecutor(
            jobs, mp_context=multiprocessing.get_context("spawn"),
            max_tasks_per_child=1) as pool:
        futs = [pool.submit(functools.partial(_timed, fn), c)
                for c in cells]
        for f in cf.as_completed(futs):
            yield f.result()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--quant", action="store_true", default=True)
    ap.add_argument("--no-quant", dest="quant", action="store_false")
    ap.add_argument("--accum", default="auto")
    ap.add_argument("--baked", action="store_true", default=True,
                    help="serve with pre-quantized weights (deployable)")
    ap.add_argument("--no-baked", dest="baked", action="store_false")
    ap.add_argument("--reduced", action="store_true",
                    help="the smoke configs (seconds a cell)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in its own process")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import ASSIGNED_SHAPES
    archs = configs.ARCH_IDS if args.arch == "all" else [
        configs.canonical(args.arch)]
    shapes = (list(ASSIGNED_SHAPES) if args.shape == "all"
              else [args.shape])
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    outdir = pathlib.Path(args.out)

    summary = []
    t_all = time.time()
    cells = sorted(((arch, shp, mp) for arch in archs for shp in shapes
                    for mp in meshes), key=_cost)
    one = functools.partial(_grid_cell, quant=args.quant, outdir=outdir,
                            accum=args.accum, reduced=args.reduced,
                            baked=args.baked)
    for arch, shp, mp, rec, secs in _cells(cells, args.jobs, one):
        status = rec["status"]
        extra = ""
        if status == "ok":
            gb = rec["memory"]["peak_bytes"] / 2**30
            extra = (f" peak/rank={gb:.2f}GiB "
                     f"flops/rank={rec['flops_per_device']:.3e}")
        elif status == "failed":
            extra = " " + rec["error"][:120]
        elif status == "skipped":
            extra = " " + rec["reason"]
        print(f"[{status:7s}] {arch:22s} {shp:12s} "
              f"{'multi' if mp else 'single':6s}{extra} ({secs:.0f}s)",
              flush=True)
        summary.append(rec)
    n_ok = sum(1 for r in summary if r["status"] == "ok")
    n_skip = sum(1 for r in summary if r["status"] == "skipped")
    n_fail = sum(1 for r in summary if r["status"] == "failed")
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_fail} FAILED ({time.time() - t_all:.0f}s)")
    outdir.mkdir(parents=True, exist_ok=True)
    (outdir / "summary.json").write_text(json.dumps(summary, indent=1))
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
