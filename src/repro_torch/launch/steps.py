"""Train / prefill / serve step builders — the port of
``repro.launch.steps``.

The step functions are closed over the ArchConfig and are what the trainer
and the serving entry points run. The JAX module's abstract shapes
(``abstract_params``, ``abstract_opt_state``, ``abstract_cache``) and
``input_specs`` serve its dry run and its shardings; they come with the
port of ``launch/dryrun.py`` and the parallel layouts (ROADMAP Queue 1
item 6).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.quantize import QuantMode
from repro_torch.models import api
from repro_torch.training import optimizer as opt


def param_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _value_and_grad(params, cfg: ArchConfig, batch: dict, qm: QuantMode):
    """(loss, grads) of ``api.lm_loss`` at ``params``; grads share the
    tree and the dtypes of ``params``."""
    leaves = opt.tree_leaves(params)
    live = [t.detach().requires_grad_(True) for t in leaves]
    it = iter(live)
    tree = opt.tree_map(lambda _: next(it), params)
    loss = api.lm_loss(tree, cfg, batch, qm)
    gs = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
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


def make_prefill_step(cfg: ArchConfig, qm: QuantMode = QuantMode.off()):
    """The prompt step: (params, inputs) -> (next tokens, cache); for an
    encoder, the full bidirectional forward's per-frame argmax (there is
    no cache)."""
    if cfg.family == "encoder":
        def encoder_step(params, inputs):
            with torch.no_grad():
                logits = api.forward(params, cfg, inputs, qm)
            return logits.argmax(dim=-1).to(torch.int32)
        return encoder_step

    def prefill_step(params, inputs):
        with torch.no_grad():
            logits, cache = api.prefill(params, cfg, inputs, qm)
        return logits.argmax(dim=-1).to(torch.int32), cache
    return prefill_step


def make_serve_step(cfg: ArchConfig, qm: QuantMode = QuantMode.off()):
    """One decode step: new token in, next token + updated cache out."""
    def serve_step(params, cache, inputs, cur_len):
        with torch.no_grad():
            logits, cache = api.decode(params, cfg, cache, inputs, cur_len,
                                       qm)
        return logits.argmax(dim=-1).to(torch.int32), cache
    return serve_step
