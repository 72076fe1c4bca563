"""LATMiX — learning the affine transformations Ω (Section 3.2); the port
of ``repro.core.latmix``.

Stage 1 of the PTQ pipeline: with FP weights, learn T1 (global, d_model)
and T2 (per attention layer, head_dim) by minimizing
``L = KL(f(x) || f̃_Ω(x)) + λ·L_vol`` (Eq. 9) over a small calibration set,
where f̃_Ω is the *folded* network (the fold is differentiable, so
transforming activations ≡ folding) executed with MX fake-quantized
activations (straight-through gradient).

The same machinery, restricted, yields the baselines: kind 'orthogonal'
(SpinQuant-like), 'invertible' without bias ("Learned Inv. Matrix"),
'kron' (FlatQuant's structure), granularity 'block' (BRQ / MR-GPTQ-style),
and the fixed kinds ('hadamard', ...; QuaRot, no training).

Ω is drawn from ``lx.seed`` with ``jax.random``'s key tree
(``core/prng.py``) and everything runs where the parameters live.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import torch

from repro_torch import devices
from repro_torch.configs.base import ArchConfig
from repro_torch.models import api
from repro_torch.training import optimizer as opt

from . import mx as mxlib
from . import prng
from . import transforms as tfm
from .folding import TransformSet
from .quantize import QuantMode


@dataclasses.dataclass(frozen=True)
class LatmixConfig:
    kind: str = "lu"                 # transform family (see module doc)
    granularity: str = "full"        # 'full' | 'block'
    learn_bias: bool = True
    learn_t2: bool = True
    act_fmt: str = "mxfp4"
    block_size: int = 32
    scale_mode: str = "pow2"         # 'fp8' => NVFP4 (App. E.6)
    t3_block: int = 32
    steps: int = 150
    lr: float = 1e-3
    weight_decay: float = 1e-4
    lambda_vol: float = 0.1
    lambda_diag: float = 0.1
    temperature: float = 1.5
    loss: str = "kl"                 # 'kl' | 'ce' | 'mse'
    seed: int = 0

    @property
    def trainable(self) -> bool:
        return self.kind not in ("hadamard", "block_hadamard", "identity")


def _n_t2(cfg: ArchConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.n_super_blocks
    return cfg.n_layers


def t2_applicable(cfg: ArchConfig) -> bool:
    return cfg.family != "ssm"       # attention-free: no value path


def _specs(cfg: ArchConfig, lx: LatmixConfig):
    init = ("bd_hadamard" if lx.kind in ("lu", "invertible", "kron")
            else "bd_orthogonal")
    s1 = tfm.TransformSpec(kind=lx.kind, d=cfg.d_model,
                           learn_bias=lx.learn_bias, block=lx.block_size,
                           init=init, granularity=lx.granularity)
    s2 = tfm.TransformSpec(kind=lx.kind, d=cfg.head_dim,
                           learn_bias=lx.learn_bias,
                           block=min(lx.block_size, cfg.head_dim),
                           init=init, granularity=lx.granularity)
    return s1, s2


def init_omega(key, cfg: ArchConfig, lx: LatmixConfig):
    """Ω from a ``core.prng`` key: T1 from its first split, the stacked
    per-layer T2's from the second (``repro.core.latmix.init_omega``'s
    key tree)."""
    s1, s2 = _specs(cfg, lx)
    k1, k2 = prng.split(key)
    omega = {"t1": tfm.init_params(k1, s1)}
    if lx.learn_t2 and t2_applicable(cfg):
        keys = prng.split(k2, _n_t2(cfg))
        omega["t2"] = tfm.stack_trees([tfm.init_params(k, s2) for k in keys])
    return omega


def materialize_set(omega, cfg: ArchConfig, lx: LatmixConfig) -> TransformSet:
    s1, s2 = _specs(cfg, lx)
    a1, v1 = tfm.materialize(omega["t1"], s1)
    if "t2" in omega:
        a2, v2 = tfm.materialize(omega["t2"], s2)
    else:
        n = _n_t2(cfg)
        a2 = torch.eye(cfg.head_dim, device=a1.device)[None].repeat(n, 1, 1)
        v2 = torch.zeros((n, cfg.head_dim), device=a1.device)
    return TransformSet(a1=a1, v1=v1, a2=a2, v2=v2, t3_block=lx.t3_block)


def reg_loss(omega, cfg: ArchConfig, lx: LatmixConfig) -> torch.Tensor:
    s1, s2 = _specs(cfg, lx)
    vol = tfm.loss_vol(omega["t1"], s1)
    dia = tfm.diag_reg(omega["t1"])
    if "t2" in omega:
        vol = vol + torch.sum(tfm.loss_vol(omega["t2"], s2))
        dia = dia + tfm.diag_reg(omega["t2"])
    return lx.lambda_vol * vol + lx.lambda_diag * dia


def student_qm(lx: LatmixConfig) -> QuantMode:
    """Stage-1 student: quantized activations, FP weights (Liu et al.)."""
    return QuantMode(enabled=True,
                     act_cfg=mxlib.MXConfig(fmt=lx.act_fmt,
                                            block_size=lx.block_size,
                                            scale_mode=lx.scale_mode),
                     weight_cfg=None, t3_block=lx.t3_block)


def batch_to(batch: dict, device) -> dict:
    """A calibration batch (numpy or torch) on device: integer leaves
    (tokens, labels) as int64, float leaves (stub-frontend embeddings) as
    float32."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v, device=device)
        out[k] = t.float() if t.is_floating_point() else t.long()
    return out


def _grads(loss: torch.Tensor, learn: dict) -> dict:
    """d loss / d every leaf of ``learn`` (zeros where a leaf is unused)."""
    leaves = opt.tree_leaves(learn)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, gs))
    return opt.tree_map(lambda _: next(it), learn)


def learn_transforms(params, cfg: ArchConfig, lx: LatmixConfig,
                     calib_batches: List[dict],
                     log: Optional[Callable[[str], None]] = None):
    """Run stage 1 where ``params`` live. ``params`` must already be
    norm-folded (:func:`api.fold_norms`). Returns (omega, TransformSet,
    history); the history records the loss, task loss and gradient norm at
    every tenth of the steps and at the last, before that step's
    update."""
    dev = devices.of(params)
    omega = init_omega(prng.prng_key(lx.seed, dev), cfg, lx)
    qm = student_qm(lx)
    batches = [batch_to(b, dev) for b in calib_batches]

    # teacher logits are fixed -> computed once per calibration batch
    with torch.no_grad():
        teachers = [api.forward(params, cfg, b["inputs"]) for b in batches]

    if not lx.trainable:
        with torch.no_grad():
            return omega, materialize_set(omega, cfg, lx), []

    ocfg = opt.AdamWConfig(lr=lx.lr, weight_decay=lx.weight_decay,
                           warmup_steps=max(1, lx.steps // 10),
                           total_steps=lx.steps, grad_clip=1.0)
    # gradients only for the 'learn' subtrees (fixed buffers hold int perms)
    learn = {k: v["learn"] for k, v in omega.items()}
    fixed = {k: v["fixed"] for k, v in omega.items()}
    state = opt.init_state(learn)

    def join(learn):
        return {k: {"learn": learn[k], "fixed": fixed[k]} for k in learn}

    def loss_fn(learn, batch, teacher):
        om = join(learn)
        folded = api.fold(params, cfg, materialize_set(om, cfg, lx))
        student = api.forward(folded, cfg, batch["inputs"], qm)
        if lx.loss == "kl":
            task = api.kl_divergence(teacher, student, lx.temperature)
        elif lx.loss == "ce":
            task = api.cross_entropy(student, batch["labels"])
        else:  # 'mse' on logits (FlatQuant-style local objective proxy)
            task = torch.mean((student.float() - teacher.float()) ** 2)
        return task + reg_loss(om, cfg, lx), task

    hist = []
    t0 = time.time()
    every = max(1, lx.steps // 10)
    for i in range(lx.steps):
        n = i % len(batches)
        learn = opt.tree_map(lambda t: t.detach().requires_grad_(True), learn)
        loss, task = loss_fn(learn, batches[n], teachers[n])
        grads = _grads(loss, learn)
        learn, state, info = opt.apply_updates(learn, grads, state, ocfg)
        if i % every == 0 or i == lx.steps - 1:
            rec = {"step": i, "loss": loss.item(), "task": task.item(),
                   "grad_norm": info["grad_norm"].item()}
            hist.append(rec)
            if log:
                log(f"[latmix:{lx.kind}] step {i:4d} loss={rec['loss']:.4f} "
                    f"task={rec['task']:.4f} ({time.time()-t0:.1f}s)")
    omega = join(learn)
    with torch.no_grad():
        return omega, materialize_set(omega, cfg, lx), hist


def transform_metrics(omega, cfg: ArchConfig, lx: LatmixConfig) -> dict:
    """Fig. 3 metrics: orthogonality deviation, off-block spectral norm and
    the condition number of A1."""
    with torch.no_grad():
        a1 = materialize_set(omega, cfg, lx).a1
        return {
            "orthogonality_deviation": float(tfm.orthogonality_deviation(a1)),
            "offblock_norm": float(tfm.offblock_norm(a1, lx.block_size)),
            "condition_number": float(torch.linalg.cond(a1)),
        }
