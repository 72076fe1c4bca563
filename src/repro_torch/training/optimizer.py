"""AdamW + global-norm gradient clipping + the warmup/cosine schedule — the
port of ``repro.training.optimizer``, as functions over tensor trees
(nested dicts of tensors).

The update is the JAX package's, not ``torch.optim.AdamW``'s: the gradient
is clipped by the global norm first, the decay term is added to the
bias-corrected Adam direction (only on leaves of two or more dimensions),
and the learning rate follows ``schedule_lr``. Everything is float32, and
trees are walked in sorted key order (``jax.tree``'s order), so the global
norm sums its leaves in the same order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


class AdamWState(NamedTuple):
    step: int
    m: dict
    v: dict


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"     # 'cosine' | 'constant' | 'linear'
    min_lr_frac: float = 0.1


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict in sorted key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def schedule_lr(cfg: AdamWConfig, step: int) -> float:
    """The learning rate at ``step`` (0-based), in float32: a warmup from
    0.1x (paper D.1: start/end factors 0.1 -> 1) times the decay."""
    f = np.float32
    s = f(step)
    warm = np.minimum(f(1.0), (s + f(1.0)) / f(max(cfg.warmup_steps, 1)))
    warm = f(0.1) + f(0.9) * warm
    frac = np.clip(s / f(max(cfg.total_steps, 1)), f(0.0), f(1.0))
    if cfg.schedule == "constant":
        decay = f(1.0)
    elif cfg.schedule == "linear":
        decay = f(1.0) - (f(1.0) - f(cfg.min_lr_frac)) * frac
    else:
        decay = (f(cfg.min_lr_frac) + (f(1.0) - f(cfg.min_lr_frac))
                 * f(0.5) * (f(1.0) + np.cos(f(math.pi) * frac)))
    return float(f(cfg.lr) * warm * decay)


def init_state(params) -> AdamWState:
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    return AdamWState(step=0, m=zeros,
                      v=tree_map(torch.clone, zeros))


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    sq = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        sq = sq + torch.sum(torch.square(g.float()))
    return torch.sqrt(sq)


def apply_updates(params, grads, state: AdamWState, cfg: AdamWConfig,
                  mask: Optional[Callable] = None):
    """One AdamW step. ``mask(leaf)`` may disable weight decay (by default
    only leaves of two or more dimensions decay). Returns (new params,
    new state, {"grad_norm", "lr"}); the new leaves are fresh tensors
    without autograd history."""
    with torch.no_grad():
        gnorm = global_norm(grads)
        scale = (torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
                 if cfg.grad_clip else None)
        step = state.step + 1
        lr = schedule_lr(cfg, state.step)
        b1c = float(np.float32(1.0) - np.float32(cfg.b1) ** np.float32(step))
        b2c = float(np.float32(1.0) - np.float32(cfg.b2) ** np.float32(step))

        def upd(p, g, m, v):
            g = g.float() if scale is None else g.float() * scale
            m = cfg.b1 * m + (1 - cfg.b1) * g
            v = cfg.b2 * v + (1 - cfg.b2) * g * g
            delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            if cfg.weight_decay and (p.ndim >= 2 if mask is None
                                     else mask(p)):
                delta = delta + cfg.weight_decay * p.float()
            return (p.float() - lr * delta).to(p.dtype), m, v

        out = tree_map(upd, params, grads, state.m, state.v)
    return (_unzip(out, 0), AdamWState(step=step, m=_unzip(out, 1),
                                       v=_unzip(out, 2)),
            {"grad_norm": gnorm, "lr": lr})


def _unzip(tree, i: int):
    if isinstance(tree, dict):
        return {k: _unzip(v, i) for k, v in tree.items()}
    return tree[i]
