"""Training loop of the port — ``repro.training.trainer``: gradient
accumulation, activation checkpointing (``cfg.remat``), deterministic-by-step
data, checkpoint/resume, the straggler watchdog, and the failure-injection
hook of the fault-tolerance tests.

``mesh=None`` trains on one device. With a mesh (``launch/mesh.py``) the
trainer does what the JAX trainer does: parameters FSDP over "data" × TP
over "model" (``params_shardings(..., "train")``) as DTensors, the AdamW
moments mirroring them (ZeRO-3), the batch sharded by
``train_batch_shardings``, and each step run under ``pctx.activate``.
Checkpoints hold whole tensors either way (written by rank 0), so a run
under one mesh resumes under another or under none.

On the card each step runs under ``torch.use_deterministic_algorithms``
(the embedding's scatter-add backward takes its sorted, deterministic
kernel), so a run resumed from a checkpoint repeats the uninterrupted run's
losses bit for bit.
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
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import synthetic
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import pcontext as pctx
from repro_torch.launch import shardings as sh
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
                 log: Callable[[str], None] = print, mesh=None):
        """``device`` None means the CUDA card; the CPU runs only when
        asked for. With ``mesh`` the device is the mesh's (this rank's
        card under NCCL, the CPU under gloo)."""
        self.cfg, self.tc, self.log = cfg, tc, log
        self.mesh = mesh
        if mesh is not None:
            device = ("cpu" if mesh.device_type == "cpu" else
                      torch.device("cuda", torch.cuda.current_device()))
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
    def _active(self):
        """The partitioning context of a step (none without a mesh)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return pctx.activate(self.mesh,
                             batch_axes=mesh_lib.dp_axes(self.mesh),
                             model_axis=mesh_lib.model_axis(self.mesh),
                             seq_axis=None)

    def _place(self, name, leaf):
        """A parameter leaf as each rank keeps it under the mesh (FSDP over
        "data" × TP over "model")."""
        return sh.distribute_leaf(leaf, sh.NamedSharding(
            self.mesh, sh.param_spec(name, leaf.shape, self.cfg, "train",
                                     self.mesh)))

    def init_or_resume(self):
        """Seeded parameters and fresh AdamW moments, or the latest
        checkpoint. Under the mesh no whole tree reaches the device: each
        leaf is laid out as it is made or read, and the moments are made
        from the shards."""
        if self.mesh is not None:
            shape = ShapeConfig("custom", self.tc.seq_len,
                                self.tc.batch_size, "train")
            self._batch_sh = sh.train_batch_shardings(self.cfg, shape,
                                                      self.mesh)
        latest = ckpt_lib.latest_step(self.tc.ckpt_dir)
        if latest is None:
            gen = torch.Generator(device=self.device).manual_seed(
                self.tc.seed)
            params = api.init(gen, self.cfg, steps_lib.param_dtype(self.cfg),
                              device=self.device,
                              place=None if self.mesh is None else self._place)
            opt_state = opt.init_state(params)
        else:
            params = steps_lib.abstract_params(self.cfg)
            opt_state = opt.init_state(params)
            shards = None
            if self.mesh is not None:
                psh = sh.params_shardings(params, self.cfg, "train",
                                          self.mesh)
                shards = {"params": psh, "opt": sh.opt_state_shardings(
                    opt_state, psh, self.mesh)}
            restored, manifest = ckpt_lib.restore(
                self.tc.ckpt_dir, {"params": params, "opt": opt_state},
                device=self.device, shardings=shards)
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
        if self.mesh is not None:
            out = sh.distribute(out, {k: self._batch_sh[k] for k in out})
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
            with _deterministic(self.device), self._active():
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
        with torch.no_grad(), self._active():
            for i in range(1000, 1000 + n_batches):
                b = self._batch(i)
                logits = api.forward(self.params, self.cfg, b["inputs"])
                ce = api.cross_entropy(logits, b["labels"])
                tot += float(ce.full_tensor() if pctx.is_dtensor(ce) else ce)
                cnt += 1
        return math.exp(tot / cnt)
