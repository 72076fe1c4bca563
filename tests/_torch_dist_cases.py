"""Rank program of ``tests/test_torch_distributed.py``: one process of a
4-rank gloo group over a (2, 2) ("data", "model") mesh, started from a
``FileStore``:

    python tests/_torch_dist_cases.py CASE[,CASE...] RANK WORLD DIR

runs each ``case_CASE(mesh, rank, DIR)`` in turn; rank 0 writes a case's
result (or its error) to ``DIR/result_CASE.json``. The inputs the test
made from a numpy seed arrive as ``DIR/params_TAG.npz`` and
``DIR/batch_TAG.npz``, TAG one of :data:`CONFIGS`' keys.
"""
import json
import pathlib
import sys
import time
import traceback

import numpy as np
import torch

torch.set_num_threads(1)

from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ArchConfig, ShapeConfig  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import pcontext as pctx  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402

DENSE = ArchConfig(name="t", family="dense", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                   attn_chunk=64)


def _reduced(arch):
    from repro_torch import configs
    return configs.get_reduced(arch)


CONFIGS = {"dense": lambda: DENSE,
           "moe": lambda: _reduced("qwen2-moe-a2.7b"),
           "hybrid": lambda: _reduced("recurrentgemma-2b"),
           "ssm": lambda: _reduced("mamba2-130m")}


def _np_tree(path):
    """A nested dict of numpy arrays from an npz whose keys are paths."""
    out = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            *parts, last = key.split("/")
            for p in parts:
                node = node.setdefault(p, {})
            node[last] = z[key]
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _maxdiff(a, b) -> float:
    return max(float((x.double() - y.double()).abs().max())
               for (_, x), (_, y) in zip(_flat(a), _flat(b)))


def _off():
    from repro_torch.core.quantize import QuantMode
    return QuantMode.off()


def _params(d, tag):
    return convert.params_from_numpy(_np_tree(d / f"params_{tag}.npz"),
                                     "cpu")


def _train(tag, mesh, rank, d, accum=2, lr=1e-3, seq_axis="model"):
    cfg = CONFIGS[tag]()
    params = _params(d, tag)
    batch = {k: torch.as_tensor(v).long()
             for k, v in np.load(d / f"batch_{tag}.npz").items()}
    state = opt.init_state(params)
    step = steps.make_train_step(cfg, opt.AdamWConfig(lr=lr), accum=accum)

    psh = sh.params_shardings(params, cfg, "train", mesh)
    osh = sh.opt_state_shardings(state, psh, mesh)
    B, S = batch["inputs"].shape
    bsh = sh.train_batch_shardings(cfg, ShapeConfig("t", S, B, "train"),
                                   mesh)
    dp, ds = sh.distribute(params, psh), sh.distribute(state, osh)
    db = sh.distribute(batch, bsh)
    with pctx.activate(mesh, batch_axes=mesh_lib.dp_axes(mesh),
                       model_axis="model", seq_axis=seq_axis):
        _, g2 = steps._value_and_grad(dp, cfg, db, _off())
        p2, s2, loss2, _ = step(dp, ds, db)
    g2 = sh.gather(g2)
    kept = all(a.placements == b.placements
               for (_, a), (_, b) in zip(_flat(p2), _flat(dp)))
    layouts = {k: [f"S{p.dim}" if p.is_shard() else "R"
                   for p in t.placements] for k, t in _flat(dp)}
    p2 = sh.gather(p2)
    if rank != 0:                 # the unsharded reference: rank 0 only
        return {}
    _, g1 = steps._value_and_grad(params, cfg, batch, _off())
    p1, _, loss1, _ = step(params, state, batch)
    gscale = max(float(g.abs().max()) for _, g in _flat(g1))
    return {"dl": abs(float(loss1) - float(loss2)),
            "dp": _maxdiff(p1, p2), "loss": float(loss2),
            "dg_rel": _maxdiff(g1, g2) / gscale,
            "placements_kept": kept, "layouts": layouts}


def case_train(mesh, rank, d):
    return _train("dense", mesh, rank, d)


def _serve(tag, mesh, rank, d, qm, steps_n=4, kv_quant=None, max_len=48,
           params=None):
    """Prefill + ``steps_n`` greedy decode steps through the step
    step functions, unsharded and under the mesh (params in serve layout, the
    cache by ``cache_shardings``), with each run's kernel-wrapper calls
    (``ops.quant_paths``)."""
    from repro_torch.core.quantize import KVCacheQuant
    from repro_torch.kernels import ops
    cfg = CONFIGS[tag]()
    if params is None:
        params = _params(d, tag)
    prompts = torch.as_tensor(np.load(d / f"batch_{tag}.npz")["inputs"]
                              ).long()
    B, S = prompts.shape
    kq = KVCacheQuant.parse(kv_quant) if kv_quant else None
    serve = steps.make_serve_step(cfg, qm)

    def run(params, dist_cache):
        with torch.no_grad():
            logits, cache = api.prefill(params, cfg, prompts, qm,
                                        max_len=max_len, kv_quant=kq)
        if dist_cache is not None:
            cache = dist_cache(cache)
        tok = logits.argmax(-1)
        toks, lgs = [tok], [logits]
        for i in range(steps_n):
            with torch.no_grad():
                lg, cache = api.decode(params, cfg, cache, tok, S + i, qm)
            tok = lg.argmax(-1)
            toks.append(tok)
            lgs.append(lg)
        nxt, _ = serve(params, cache, tok, S + steps_n)
        toks.append(nxt)
        return toks, lgs

    psh = sh.params_shardings(params, cfg, "serve", mesh)
    dp = sh.distribute(params, psh)
    ops.reset_launches()
    with pctx.activate(mesh, batch_axes=mesh_lib.dp_axes(mesh),
                       model_axis="model"):
        t2, l2 = run(dp, lambda c: sh.distribute(
            c, sh.cache_shardings(c, cfg, B, mesh)))
    paths2 = dict(ops.quant_paths)
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
    t2 = [full(t) for t in t2]
    l2 = [full(t) for t in l2]
    if rank != 0:                 # the unsharded reference: rank 0 only
        return {}
    ops.reset_launches()
    t1, l1 = run(params, None)
    paths1 = dict(ops.quant_paths)
    scale = max(float(l.abs().max()) for l in l1)
    return {"tokens_equal": all(bool((a == b).all())
                                for a, b in zip(t1, t2)),
            "n_diff": sum(int((a != b).sum()) for a, b in zip(t1, t2)),
            "logit_rel": max(float((a.double() - b.double()).abs().max())
                             for a, b in zip(l1, l2)) / scale,
            "tokens": [t.tolist() for t in t1],
            "paths": {"/".join(k): v for k, v in paths1.items()},
            "paths_mesh": {"/".join(k): v for k, v in paths2.items()}}


def case_serve(mesh, rank, d):
    from repro_torch.core.quantize import QuantMode
    return _serve("dense", mesh, rank, d, QuantMode.off())


def case_serve_mx(mesh, rank, d):
    from repro_torch.core.quantize import QuantMode
    return _serve("dense", mesh, rank, d, QuantMode.mxfp4(weights=False),
                  kv_quant="mxfp8")


def case_train_moe(mesh, rank, d):
    return _train("moe", mesh, rank, d)


def case_serve_fused(mesh, rank, d):
    """A packed RTN mxfp4 tree (T3 before ffn_down) on the fused backend
    with an mxfp8 cache: every kernel wrapper call under the mesh takes
    the replicated route."""
    import dataclasses
    from repro_torch.artifacts.store import pack_params
    from repro_torch.core import ptq
    res = ptq.apply_method("rtn", _params(d, "dense"), DENSE, fmt="mxfp4")
    qm = dataclasses.replace(res.qm, t3_block=32, backend="fused")
    return _serve("dense", mesh, rank, d, qm, kv_quant="mxfp8",
                  params=pack_params(res))


def _bitwise(a, b) -> bool:
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(_flat(a),
                                                           _flat(b)))


def case_elastic(mesh, rank, d):
    """Checkpoints across meshes, bit for bit: the JAX package's and the
    port's unsharded saves restored under the mesh, a save under the mesh
    restored unsharded; the Trainer with and without the mesh."""
    from torch.distributed.tensor import DTensor
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.trainer import TrainConfig, Trainer
    params = _params(d, "dense")
    psh = sh.params_shardings(params, DENSE, "train", mesh)
    out = {}
    r1, m1 = ckpt.restore(d / "jax_ckpt", params, device="cpu",
                          shardings=psh)
    out["jax_to_mesh"] = (m1["step"] == 7 and _bitwise(sh.gather(r1), params)
                          and all(isinstance(t, DTensor) and t.placements
                                  == s.placements for (_, t), (_, s) in
                                  zip(_flat(r1), _flat(psh))))
    ckpt.save(d / "port_ckpt", 3, params)
    r2, _ = ckpt.restore(d / "port_ckpt", params, device="cpu",
                         shardings=psh)
    out["port_to_mesh"] = _bitwise(sh.gather(r2), params)
    dparams = sh.distribute(params, psh)
    state = opt.init_state(params)
    dstate = sh.distribute(state, sh.opt_state_shardings(state, psh, mesh))
    ckpt.save(d / "mesh_ckpt", 5, {"params": dparams, "opt": dstate})
    r3, _ = ckpt.restore(d / "mesh_ckpt", {"params": params, "opt": state},
                         device="cpu")
    out["mesh_to_plain"] = (_bitwise(r3["params"], params)
                            and _bitwise(r3["opt"].m, state.m))

    losses = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        tc = TrainConfig(steps=2, batch_size=8, seq_len=32, log_every=1,
                         ckpt_every=2, ckpt_dir=str(d / f"tr_{name}"),
                         opt=opt.AdamWConfig(lr=1e-3))
        tr = Trainer(DENSE, tc, device="cpu", mesh=m, log=lambda s: None)
        losses[name] = [r["loss"] for r in tr.train()]
        out[f"{name}_params"] = tr.params
    out["losses"] = losses
    out["loss_rel"] = max(abs(a - b) / abs(a) for a, b in
                          zip(losses["plain"], losses["mesh"]))
    tree_like = {"params": params, "opt": state}
    plain_ck, _ = ckpt.restore(d / "tr_plain", tree_like, device="cpu")
    mesh_ck, _ = ckpt.restore(d / "tr_mesh", tree_like, device="cpu")
    out["trainer_mesh_ckpt_whole"] = _bitwise(
        mesh_ck["params"], sh.gather(out.pop("mesh_params")))
    out["trainer_plain_ckpt_whole"] = _bitwise(plain_ck["params"],
                                               out.pop("plain_params"))
    back, _ = ckpt.restore(d / "tr_plain", tree_like, device="cpu",
                           shardings={"params": psh, "opt":
                                      sh.opt_state_shardings(state, psh,
                                                             mesh)})
    out["plain_ckpt_to_mesh"] = _bitwise(sh.gather(back["params"]),
                                         plain_ck["params"])
    return out


def case_init_memory(mesh, rank, d):
    """One rank's peak live bytes while ``Trainer(mesh=)`` makes its
    parameters and AdamW moments, beside its shards and the whole tree."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.dryrun import LocalCounter
    from repro_torch.training.trainer import TrainConfig, Trainer
    tc = TrainConfig(steps=1, batch_size=8, seq_len=32,
                     ckpt_dir=str(d / f"mem_{rank}"))
    tr = Trainer(DENSE, tc, device="cpu", mesh=mesh, log=lambda s: None)
    counter = LocalCounter()
    with counter.mode:
        tr.init_or_resume()
    params = opt.tree_leaves(tr.params)
    state = params + opt.tree_leaves(tr.opt_state.m) + \
        opt.tree_leaves(tr.opt_state.v)
    local = [t.to_local() if isinstance(t, DTensor) else t for t in state]
    return {"peak": counter.peak,
            "shards": sum(t.numel() * t.element_size() for t in local),
            "whole": sum(t.numel() * t.element_size() for t in state),
            "largest_f32": max(t.numel() * 4 for t in params),
            "all_dtensors": all(isinstance(t, DTensor) for t in state)}


def case_serve_hybrid(mesh, rank, d):
    from repro_torch.core.quantize import QuantMode
    return _serve("hybrid", mesh, rank, d, QuantMode.off())


def case_serve_ssm(mesh, rank, d):
    from repro_torch.core.quantize import QuantMode
    return _serve("ssm", mesh, rank, d, QuantMode.off())


CASES = {k[5:]: v for k, v in dict(globals()).items()
         if k.startswith("case_")}


def main():
    cases, rank, world = sys.argv[1].split(","), int(sys.argv[2]), \
        int(sys.argv[3])
    d = pathlib.Path(sys.argv[4])
    store = torch.distributed.FileStore(str(d / "store"), world)
    mesh_lib.init_distributed(store=store, world_size=world, rank=rank,
                              device="cpu")
    try:
        mesh = mesh_lib.make_mesh((2, world // 2), ("data", "model"))
        for case in cases:
            t0 = time.time()
            try:
                res = CASES[case](mesh, rank, d)
            except Exception:                     # every rank fails alike
                res = {"error": traceback.format_exc()[-3000:]}
            res["seconds"] = time.time() - t0
            if rank == 0:
                (d / f"result_{case}.json").write_text(json.dumps(res))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
