"""Training loop of the port — ``repro.training.trainer`` on one device:
gradient accumulation, activation checkpointing (``cfg.remat``),
deterministic-by-step data, checkpoint/resume, the straggler watchdog, and
the failure-injection hook of the fault-tolerance tests.

The JAX trainer's mesh, ``pcontext`` and shardings belong to the parallel
layouts (ROADMAP Queue 1 item 6); this trainer has no mesh argument. On
the card each step runs under ``torch.use_deterministic_algorithms`` (the
embedding's scatter-add backward takes its sorted, deterministic kernel),
so a run resumed from a checkpoint repeats the uninterrupted run's losses
bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Callable, Optional

import torch

from repro_torch import devices
from repro_torch.configs.base import ArchConfig
from repro_torch.data import synthetic
from repro_torch.launch import steps as steps_lib
from repro_torch.models import api
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training import optimizer as opt


@dataclasses.dataclass
class TrainConfig:
    steps: int = 200
    batch_size: int = 8
    seq_len: int = 128
    accum: int = 1
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    keep: int = 3
    log_every: int = 10
    seed: int = 0
    watchdog_factor: float = 10.0   # straggler alarm: step > factor×median
    opt: opt.AdamWConfig = dataclasses.field(default_factory=opt.AdamWConfig)


@contextlib.contextmanager
def _deterministic(dev: torch.device):
    """Deterministic kernels on the card for the span of a step (only a
    warning where an op has none); nothing changes on the CPU."""
    if dev.type != "cuda":
        yield
        return
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


class Trainer:
    def __init__(self, cfg: ArchConfig, tc: TrainConfig, device=None,
                 log: Callable[[str], None] = print):
        """``device`` None means the CUDA card; the CPU runs only when
        asked for."""
        self.cfg, self.tc, self.log = cfg, tc, log
        self.device = devices.resolve(device)
        self.source = synthetic.make_source(cfg, tc.batch_size, tc.seq_len,
                                            tc.seed)
        self.step_fn = None
        self.params = None
        self.opt_state = None
        self.step = 0
        self.metrics = []
        self.step_times = []

    # -- setup ---------------------------------------------------------------
    def init_or_resume(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        params = api.init(gen, self.cfg, steps_lib.param_dtype(self.cfg),
                          device=self.device)
        opt_state = opt.init_state(params)
        latest = ckpt_lib.latest_step(self.tc.ckpt_dir)
        if latest is not None:
            restored, manifest = ckpt_lib.restore(
                self.tc.ckpt_dir, {"params": params, "opt": opt_state},
                device=self.device)
            params, opt_state = restored["params"], restored["opt"]
            self.step = int(manifest["step"])
            self.log(f"[trainer] resumed from step {self.step}")
        self.params, self.opt_state = params, opt_state
        self.step_fn = steps_lib.make_train_step(self.cfg, self.tc.opt,
                                                 accum=self.tc.accum)

    def _batch(self, step: int) -> dict:
        out = {}
        for k, v in self.source.batch(step).items():
            t = torch.as_tensor(v, device=self.device)
            out[k] = t if t.is_floating_point() else t.long()
        return out

    # -- loop ----------------------------------------------------------------
    def train(self, fail_at: Optional[int] = None):
        """Run to tc.steps. ``fail_at`` raises mid-run (fault injection for
        the restart tests)."""
        if self.step_fn is None:
            self.init_or_resume()
        times = self.step_times
        while self.step < self.tc.steps:
            if fail_at is not None and self.step == fail_at:
                raise RuntimeError(f"injected failure at {self.step}")
            t0 = time.time()
            batch = self._batch(self.step)
            with _deterministic(self.device):
                self.params, self.opt_state, loss, gnorm = self.step_fn(
                    self.params, self.opt_state, batch)
            loss = float(loss)
            dt = time.time() - t0
            times.append(dt)
            med = sorted(times)[len(times) // 2]
            if len(times) > 5 and dt > self.tc.watchdog_factor * med:
                self.log(f"[watchdog] step {self.step} took {dt:.2f}s "
                         f"(median {med:.2f}s) — straggler suspected")
            self.step += 1
            if self.step % self.tc.log_every == 0:
                self.metrics.append({"step": self.step, "loss": loss})
                self.log(f"[trainer] step {self.step:5d} "
                         f"loss={loss:.4f} ({dt:.2f}s)")
            if self.step % self.tc.ckpt_every == 0 or \
                    self.step == self.tc.steps:
                self.save()
        return self.metrics

    def save(self):
        ckpt_lib.save(self.tc.ckpt_dir, self.step,
                      {"params": self.params, "opt": self.opt_state},
                      keep=self.tc.keep, extra={"arch": self.cfg.name})

    def eval_ppl(self, n_batches: int = 2) -> float:
        tot, cnt = 0.0, 0
        with torch.no_grad():
            for i in range(1000, 1000 + n_batches):
                b = self._batch(i)
                logits = api.forward(self.params, self.cfg, b["inputs"])
                tot += float(api.cross_entropy(logits, b["labels"]))
                cnt += 1
        return math.exp(tot / cnt)
