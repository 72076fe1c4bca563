"""Train / prefill / serve step builders — the port of
``repro.launch.steps``.

The step functions are closed over the ArchConfig and are what the
trainer, the serving entry points and the dry run (``launch/dryrun.py``)
run. ``abstract_params`` / ``abstract_opt_state`` / ``abstract_cache`` /
``input_specs`` are ``jax.eval_shape`` stand-ins: tensors on the ``meta``
device, which carry shape and dtype and allocate nothing (DeepSeek-67B's
parameter tree is 134 GB in bf16).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.quantize import QuantMode
from repro_torch.launch import pcontext as pctx
from repro_torch.models import api
from repro_torch.training import optimizer as opt


def param_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def abstract_params(cfg: ArchConfig):
    """The parameter tree of ``cfg`` on the meta device."""
    gen = torch.Generator().manual_seed(0)
    return api.init(gen, cfg, param_dtype(cfg), device="meta")


def abstract_opt_state(cfg: ArchConfig):
    return opt.init_state(abstract_params(cfg))


def abstract_cache(cfg: ArchConfig, batch: int, max_len: int):
    return api.init_cache(cfg, batch, max_len, param_dtype(cfg),
                          device="meta")


def _like(g, p):
    """A gradient laid out as its parameter (a partial sum over the batch
    shards becomes the parameter's shards: a reduce-scatter)."""
    if pctx.is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _value_and_grad(params, cfg: ArchConfig, batch: dict, qm: QuantMode):
    """(loss, grads) of ``api.lm_loss`` at ``params``; grads share the
    tree and the dtypes of ``params``."""
    leaves = opt.tree_leaves(params)
    live = [t.detach().requires_grad_(True) for t in leaves]
    it = iter(live)
    tree = opt.tree_map(lambda _: next(it), params)
    loss = api.lm_loss(tree, cfg, batch, qm)
    if pctx.is_dtensor(loss):
        # a mesh's loss is a partial value (a mean over batch shards):
        # differentiate its whole value, so the seed gradient is replicated
        loss = loss.full_tensor()
    gs = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else _like(g, p)
              for p, g in zip(live, gs))
    return loss.detach(), opt.tree_map(lambda _: next(it), params)


def make_train_step(cfg: ArchConfig, ocfg: Optional[opt.AdamWConfig] = None,
                    qm: QuantMode = QuantMode.off(), accum: int = 1):
    """Train step with optional gradient accumulation: the batch splits
    into ``accum`` microbatches along its first axis, their gradients are
    summed in f32 and divided by ``accum``, then one AdamW update. Only
    one microbatch's activations are alive at a time. Returns
    ``train_step(params, opt_state, batch) -> (params, opt_state, loss,
    grad_norm)`` over tensor trees on the batch's device."""
    ocfg = ocfg or opt.AdamWConfig()

    def train_step(params, opt_state, batch):
        if accum <= 1:
            loss, grads = _value_and_grad(params, cfg, batch, qm)
        else:
            B = next(iter(batch.values())).shape[0]
            mb = B // accum
            grads = opt.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=next(iter(batch.values())).device)
            for i in range(accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                li, gi = _value_and_grad(params, cfg, micro, qm)
                grads = opt.tree_map(lambda a, b: a + b.float(), grads, gi)
                loss = loss + li
            grads = opt.tree_map(lambda g: g / accum, grads)
            loss = loss / accum
        params, opt_state, info = opt.apply_updates(params, grads,
                                                    opt_state, ocfg)
        return params, opt_state, loss, info["grad_norm"]
    return train_step


def _argmax(logits):
    """Greedy tokens (int32); under a mesh the vocab axis is gathered
    first (an argmax across vocab shards has no local form)."""
    return api._whole_vocab(logits).argmax(dim=-1).to(torch.int32)


def make_prefill_step(cfg: ArchConfig, qm: QuantMode = QuantMode.off(),
                      max_len: Optional[int] = None, kv_quant=None):
    """The prompt step: (params, inputs) -> (next tokens, cache); for an
    encoder, the full bidirectional forward's per-frame argmax (there is
    no cache). ``max_len`` sizes the cache for the serve steps after it
    and ``kv_quant`` stores it MX-packed (``api.prefill``'s)."""
    if cfg.family == "encoder":
        def encoder_step(params, inputs):
            with torch.no_grad():
                logits = api.forward(params, cfg, inputs, qm)
            return _argmax(logits)
        return encoder_step

    def prefill_step(params, inputs):
        with torch.no_grad():
            logits, cache = api.prefill(params, cfg, inputs, qm,
                                        max_len=max_len, kv_quant=kv_quant)
        return _argmax(logits), cache
    return prefill_step


def make_serve_step(cfg: ArchConfig, qm: QuantMode = QuantMode.off()):
    """One decode step: new token in, next token + updated cache out."""
    def serve_step(params, cache, inputs, cur_len):
        with torch.no_grad():
            logits, cache = api.decode(params, cfg, cache, inputs, cur_len,
                                       qm)
        return _argmax(logits), cache
    return serve_step


def make_latmix_step(cfg: ArchConfig, lx_cfg=None):
    """One transform-learning step (the paper's calibration workload,
    the dry run's ``calib_1k`` cell): ``latmix_step(params, learn, fixed,
    ostate, batch, teacher) -> (learn, ostate, loss)``, the KL of the
    folded student against the teacher logits plus the regularisers."""
    from repro_torch.core import latmix as lx_lib
    lx_cfg = lx_cfg or lx_lib.LatmixConfig()
    qm = lx_lib.student_qm(lx_cfg)
    ocfg = opt.AdamWConfig(lr=lx_cfg.lr, weight_decay=lx_cfg.weight_decay,
                           total_steps=lx_cfg.steps)

    def fold(params, lrn, fixed):
        om = {k: {"learn": lrn[k], "fixed": fixed[k]} for k in lrn}
        tset = lx_lib.materialize_set(om, cfg, lx_cfg)
        return api.fold(params, cfg, tset), lx_lib.reg_loss(om, cfg, lx_cfg)

    def latmix_step(params, learn, fixed, ostate, batch, teacher):
        lrn = opt.tree_map(lambda t: t.detach().requires_grad_(True), learn)
        # under a mesh the folds run on whole weights on every rank, and
        # the student runs data-parallel on them (its batch split over the
        # data axes)
        folded, reg = pctx.whole(fold, params, lrn, fixed)
        student = api.forward(folded, cfg, batch["inputs"], qm)
        kl = api.kl_divergence(teacher, student, lx_cfg.temperature)
        loss = kl + reg
        if pctx.is_dtensor(loss):
            loss = loss.full_tensor()
        grads = lx_lib._grads(loss, lrn)
        grads = opt.tree_map(_like, grads, lrn)
        learn, ostate, _ = opt.apply_updates(lrn, grads, ostate, ocfg)
        return learn, ostate, loss.detach()
    return latmix_step


# ---------------------------------------------------------------------------
# Abstract inputs per (arch × shape)
# ---------------------------------------------------------------------------

def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Meta-tensor stand-ins for every input of the cell's step (tokens
    int32, as the JAX package's)."""
    B, S = shape.global_batch, shape.seq_len
    dt = param_dtype(cfg)
    tok = torch.int32

    if shape.kind in ("train", "prefill"):
        if cfg.embed_inputs:
            inputs = _meta((B, S), tok)
        else:
            inputs = _meta((B, S, cfg.d_model), dt)
        if shape.kind == "prefill":
            return {"inputs": inputs}
        return {"batch": {"inputs": inputs, "labels": _meta((B, S), tok)}}

    # decode: one new token against a cache of seq_len
    cache = abstract_cache(cfg, B, S)
    if cfg.embed_inputs:
        inputs = _meta((B,), tok)
    else:
        inputs = _meta((B, cfg.d_model), dt)
    return {"cache": cache, "inputs": inputs, "cur_len": _meta((), tok)}
