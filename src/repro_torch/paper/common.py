"""Shared substrate of the paper's experiments: the trained benchmark
model, calibration and evaluation data, and the CSV / JSON rows — the
port's ``benchmarks/common.py``.

The paper PTQs pretrained Llama/Qwen checkpoints; offline the repo
trains its own small llama-family model on the synthetic Zipf–Markov
corpus (``experiments/bench_model/``, in the JAX package's checkpoint
format, which the port reads) and evaluates every method on it.
"""
from __future__ import annotations

import json
import pathlib
import time

import numpy as np
import torch

from repro_torch import devices
from repro_torch.configs.base import ArchConfig
from repro_torch.core import folding as fl
from repro_torch.data import synthetic
from repro_torch.models import api
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training.trainer import TrainConfig, Trainer

BENCH_DIR = pathlib.Path("experiments/bench_model")
# the port's rows go here, never over the JAX package's
# experiments/benchmarks/ records (``run --out`` changes it)
OUT_DIR = pathlib.Path("experiments/torch_paper")

BENCH_CFG = ArchConfig(
    name="bench-llama", family="dense", n_layers=4, d_model=128,
    n_heads=8, n_kv_heads=4, head_dim=16, d_ff=352, vocab_size=512,
    attn_chunk=64)

TRAIN = TrainConfig(steps=250, batch_size=16, seq_len=64,
                    ckpt_every=250, ckpt_dir=str(BENCH_DIR),
                    log_every=50,
                    opt=opt.AdamWConfig(lr=3e-3, warmup_steps=20,
                                        total_steps=250))


def get_model(log=print, outliers: bool = True, device=None):
    """The shared benchmark model on ``device`` (None: the card), trained
    with the port's Trainer only when no checkpoint is there. Returns
    (params, cfg).

    outliers=True (default): the exactly equivalent variant whose
    residual stream has the outlier channels of real LLMs (Dettmers et
    al. 2022), made by folding diag(s) with a few large entries through
    the folding machinery (Appendix C), with the JAX package's draw
    (``default_rng(13)``, five hot channels)."""
    cfg = BENCH_CFG
    dev = devices.resolve(device)
    if ckpt.latest_step(BENCH_DIR) is None:
        log(f"[bench] training base model ({cfg.param_count()/1e6:.1f}M "
            f"params, {TRAIN.steps} steps)...")
        tr = Trainer(cfg, TRAIN, device=dev, log=log)
        tr.train()
        log(f"[bench] base model ppl={tr.eval_ppl():.3f}")
    tr = Trainer(cfg, TRAIN, device=dev, log=lambda *_: None)
    tr.init_or_resume()
    params = tr.params
    if outliers:
        rng = np.random.default_rng(13)
        s = np.exp(rng.normal(0.0, 0.4, cfg.d_model)).astype(np.float32)
        hot = rng.choice(cfg.d_model, 5, replace=False)
        s[hot] *= np.asarray([8.0, 6.0, 5.0, 4.0, 4.0], np.float32)
        ts = fl.TransformSet(
            a1=torch.diag(torch.as_tensor(s, device=dev)),
            v1=torch.zeros(cfg.d_model, device=dev),
            a2=torch.eye(cfg.head_dim, device=dev)[None].repeat(
                cfg.n_layers, 1, 1),
            v2=torch.zeros((cfg.n_layers, cfg.head_dim), device=dev),
            t3_block=0)
        with torch.no_grad():
            params = api.fold(api.fold_norms(params, cfg), cfg, ts)
    return params, cfg


def calib_batches(cfg, n=4, batch=8, seq=64, seed=100, device=None):
    src = synthetic.make_source(cfg, batch, seq, 0)
    dev = devices.resolve(device)
    return [{k: torch.as_tensor(v, device=dev).long()
             for k, v in src.batch(seed + i).items()} for i in range(n)]


def eval_tokens(cfg, batch=16, seq=64, seed=5000, device=None):
    src = synthetic.make_source(cfg, batch, seq + 1, 0)
    b = src.batch(seed)
    toks = np.concatenate([b["inputs"], b["labels"][:, -1:]], axis=1)
    return torch.as_tensor(toks, device=devices.resolve(device)).long()


def eval_batches(cfg, n=3, batch=16, seq=64, seed=7000):
    src = synthetic.make_source(cfg, batch, seq, 0)
    return [src.batch(seed + i) for i in range(n)]


def sync() -> None:
    """Wait for the card (if this process uses one) before a clock read."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn, *args, reps=3, warmup=1):
    """Least wall seconds of ``fn(*args)`` over ``reps``, the card
    synchronised before each clock read."""
    for _ in range(warmup):
        fn(*args)
    ts = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn(*args)
        sync()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def emit(rows, name, persist: bool = True):
    """Print the ``name,us_per_call,derived`` CSV rows and keep the full
    records as ``OUT_DIR/<name>.json`` (persist=False skips the file)."""
    if persist:
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        (OUT_DIR / f"{name}.json").write_text(json.dumps(rows, indent=1))
    for r in rows:
        us = r.get("us_per_call", 0.0)
        print(f"{r['name']},{us:.1f},{r.get('derived', '')}")
