"""Serving entry point of the port: PTQ a model (from a training
checkpoint, or random weights) and serve it, or serve a packed MX artifact.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --reduced --ckpt-dir DIR --method rtn --fmt mxfp4 [--export ART]
    PYTHONPATH=src python -m repro_torch.launch.serve --artifact ART \
        [--eager] --backend fused --scheduler wave \
        --kv-layout contiguous --kv-cache mxfp8 --requests 8 \
        --prompt-len 64 --max-new 32 \
        [--temperature 0.8 --top-k 50 --top-p 0.95 --sample-seed 0] \
        [--spec-k 4 --spec-ngram 3] \
        [--deadline-ms MS --ttft-deadline-ms MS --max-retries N \
         --no-preemption --max-queue-depth N --admit-token-budget N] \
        [--http HOST:PORT --drain-timeout-s S] [--trace OUT.json] [--metrics]

Without ``--artifact`` it runs the JAX package's ``--arch`` mode
(``repro.launch.serve``): the arch's reduced config (``--full`` for the
published one), the latest checkpoint under ``--ckpt-dir`` restored (a
random init otherwise: "demo mode"), ``ptq.apply_method(--method, --fmt,
--steps)`` on the synthetic calibration (3 batches of 8 x 64), the result
exported as an artifact with ``--export``, then served with its weights
packed as the artifact holds them (so ``--backend fused`` runs them through
the GEMM kernel; the reference backend decodes them to the same values).
With ``--artifact`` it loads an artifact either package exported and skips
PTQ; ``--eager`` dequantizes its weights at load, so every linear takes the
reference path.

Runs on the CUDA card (``--device cuda``, the default) or, when asked, on
the CPU with the kernels' plain PyTorch versions (``--device cpu``). It
serves a synthetic wave of requests and prints throughput and the schedule
counters as JSON; with ``--http`` it serves the engine over HTTP/SSE
instead (``repro_torch.serving.server``) until SIGTERM/SIGINT, then prints
the drain report and exits 1 unless it is clean. ``--trace`` exports a
Chrome trace of the run; ``--metrics`` instruments the kernel wrappers
(``kernels.ops.instrument``: ``kernel_dispatch_calls_total``,
``kernel_dispatch_seconds_total``, ``quant_dispatch_total``, and with
``--trace`` a ``dispatch:<op>`` span per call) into the engine's registry
and prints its Prometheus exposition at exit.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--artifact", default="",
                    help="serve a packed artifact directory (skips PTQ)")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default="",
                    help="restore the latest training checkpoint here "
                         "(random weights when there is none)")
    ap.add_argument("--method", default="latmix-lu")
    ap.add_argument("--fmt", default="mxfp4")
    ap.add_argument("--steps", type=int, default=60,
                    help="transform-learning steps of --method")
    ap.add_argument("--export", default="",
                    help="export the PTQ result as a packed artifact")
    ap.add_argument("--eager", action="store_true",
                    help="with --artifact: dequantize weights at load")
    ap.add_argument("--backend", default="fused", choices=("ref", "fused"),
                    help="'fused' runs the packed weights and the quantized "
                         "KV pool through the CUDA kernels")
    ap.add_argument("--scheduler", default="wave",
                    choices=("wave", "continuous"),
                    help="'wave' = static batching; 'continuous' = lanes "
                         "refilled by chunked prefill")
    ap.add_argument("--kv-layout", default="contiguous",
                    choices=("contiguous", "paged"),
                    help="'paged' (continuous only) addresses a page pool "
                         "through block tables with prefix caching")
    ap.add_argument("--kv-cache", default="mxfp8",
                    choices=("none", "mxfp8", "mxint8", "mxfp4", "mxint4"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--page-size", type=int, default=None)
    ap.add_argument("--n-pages", type=int, default=None)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature; 0 = greedy argmax")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep only the k most likely tokens (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling: keep the smallest prefix of "
                         "tokens whose probability mass reaches p")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="base sampling seed; request i samples with "
                         "seed + i, so reruns replay token for token")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft up to K tokens a "
                         "step by prompt lookup and verify them in one "
                         "forward (0 = off; forces the continuous "
                         "scheduler)")
    ap.add_argument("--spec-ngram", type=int, default=3,
                    help="longest context n-gram the drafter matches")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="end-to-end deadline per request in milliseconds; "
                         "expired requests end TIMED_OUT")
    ap.add_argument("--ttft-deadline-ms", type=float, default=None,
                    help="time-to-first-token deadline in milliseconds "
                         "(expires requests still waiting for a lane)")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="preemptions a request survives before it ends "
                         "PREEMPTED")
    ap.add_argument("--no-preemption", dest="preemption",
                    action="store_false", default=True,
                    help="never evict a lower-priority running request")
    ap.add_argument("--http", default="", metavar="HOST:PORT",
                    help="serve over HTTP/SSE instead of the synthetic run "
                         "(PORT 0 = ephemeral; SIGTERM drains)")
    ap.add_argument("--max-queue-depth", type=int, default=None,
                    help="admission cap: shed (429 + Retry-After) past this "
                         "queue depth")
    ap.add_argument("--admit-token-budget", type=int, default=None,
                    help="admission cap: shed when queued prompt + max_new "
                         "tokens would exceed this budget")
    ap.add_argument("--drain-timeout-s", type=float, default=30.0,
                    help="with --http: how long SIGTERM waits for requests "
                         "in flight before cancelling them")
    ap.add_argument("--trace", default="", metavar="OUT.json",
                    help="export a Chrome trace of the run (opens in "
                         "Perfetto)")
    ap.add_argument("--metrics", action="store_true",
                    help="record the kernel-dispatch metrics and print the "
                         "engine's Prometheus metrics at exit")
    args = ap.parse_args(argv)
    if args.spec_k > 0:
        args.scheduler = "continuous"   # spec decoding is continuous-only

    from repro_torch.artifacts.store import pack_params
    from repro_torch.kernels import ops
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.policy import SchedulingPolicy, SpecConfig
    from repro_torch.serving.sampling import SamplingParams
    policy = SchedulingPolicy(deadline_ms=args.deadline_ms,
                              ttft_deadline_ms=args.ttft_deadline_ms,
                              preemption=args.preemption,
                              max_retries=args.max_retries,
                              max_queue_depth=args.max_queue_depth,
                              admit_token_budget=args.admit_token_budget)
    sampling = (SamplingParams(temperature=args.temperature,
                               top_k=args.top_k, top_p=args.top_p,
                               seed=args.sample_seed)
                if (args.temperature > 0 or args.top_k > 0
                    or args.top_p < 1.0) else None)
    spec = (SpecConfig(k=args.spec_k, ngram_max=args.spec_ngram)
            if args.spec_k > 0 else None)
    tracer = Tracer() if args.trace else None
    metrics = MetricsRegistry() if args.metrics else None
    if metrics is not None:          # kernel-dispatch hooks (kernels/ops.py)
        ops.instrument(metrics, tracer)
    try:
        kw = dict(batch_size=args.batch,
                  max_len=max(args.max_len, args.prompt_len + args.max_new),
                  backend=args.backend, scheduler=args.scheduler,
                  eos_id=args.eos_id, kv_cache=args.kv_cache,
                  kv_layout=args.kv_layout, page_size=args.page_size,
                  n_pages=args.n_pages, metrics=metrics, tracer=tracer,
                  policy=policy, spec=spec, device=args.device)
        if args.artifact:
            eng = Engine.from_artifact(args.artifact, eager=args.eager, **kw)
        else:
            res, cfg = ptq_from_arch(args)
            eng = Engine(pack_params(res) if res.qm.enabled
                         else res.params, cfg, res.qm, **kw)
        if args.http:
            return _serve_http(eng, args)
        res = eng.throughput(n_requests=args.requests,
                             prompt_len=args.prompt_len,
                             max_new=args.max_new, seed=args.seed,
                             sampling=sampling)
        _obs_finish(eng, args)
        print(json.dumps(res, default=str))
        return 0
    finally:
        if metrics is not None:
            ops.uninstrument()


def ptq_from_arch(args):
    """The ``--arch`` mode's model: restore ``--ckpt-dir``'s latest
    checkpoint (float32, as the JAX package restores it) or take a seeded
    random init, run ``--method`` on the synthetic calibration, export if
    asked. Returns (PTQResult, cfg)."""
    import time

    import torch

    from repro_torch import configs, devices
    from repro_torch.core import ptq
    from repro_torch.data import synthetic
    from repro_torch.models import api
    from repro_torch.training import checkpoint as ckpt

    dev = devices.resolve(args.device)
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get(args.arch))
    params = api.init(torch.Generator(device=dev).manual_seed(0), cfg,
                      device=dev)
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        tree, man = ckpt.restore(args.ckpt_dir,
                                 {"params": params, "opt": None},
                                 device=dev)
        params = tree["params"]
        print(f"loaded checkpoint step {man['step']}")
    else:
        print("no checkpoint — random init (demo mode)")
    src = synthetic.make_source(cfg, 8, 64, 0)
    calib = [src.batch(i) for i in range(3)]
    t0 = time.time()
    res = ptq.apply_method(args.method, params, cfg, calib, fmt=args.fmt,
                           steps=args.steps)
    print(f"PTQ [{args.method} / {args.fmt}] in {time.time()-t0:.0f}s")
    if args.export:
        print(f"exported artifact -> {res.export(cfg, args.export)}")
    return res, cfg


def _serve_http(eng, args) -> int:
    """--http: run the HTTP/SSE front end until SIGTERM/SIGINT, then
    print the drain report; exit 1 unless it is clean."""
    from repro_torch.serving.server import ServerConfig, serve
    host, _, port = args.http.rpartition(":")
    report = serve(eng, ServerConfig(host=host or "127.0.0.1",
                                     port=int(port or 8100),
                                     drain_timeout_s=args.drain_timeout_s))
    _obs_finish(eng, args)
    print("drain report: " + json.dumps(report), flush=True)
    return 0 if report["clean"] else 1


def _obs_finish(eng, args) -> None:
    """--trace / --metrics epilogue: the speculative-decoding acceptance
    and the latency lines, then :func:`_obs_export`."""
    if stats := eng.stats():
        if args.spec_k > 0:
            print(f"speculative decoding: "
                  f"{stats['spec_proposed_tokens']} drafted, "
                  f"{stats['spec_accepted_tokens']} accepted "
                  f"(acceptance {stats['spec_acceptance']:.2f})")
        if stats.get("ttft_p50") is not None:
            print(f"latency: ttft p50={stats['ttft_p50']*1e3:.1f}ms "
                  f"p99={stats['ttft_p99']*1e3:.1f}ms"
                  + (f", tpot p50={stats['tpot_p50']*1e3:.1f}ms"
                     if stats.get("tpot_p50") is not None else ""))
    _obs_export(eng, args)


def _obs_export(eng, args) -> None:
    """Export the Chrome trace and print the Prometheus exposition of the
    engine's registry (which carries the kernel-dispatch metrics when
    --metrics instrumented ``kernels.ops``)."""
    if args.trace:
        print(f"trace -> {eng.tracer.export(args.trace)} "
              f"({len(eng.tracer.events())} events)")
    if args.metrics:
        print(eng.metrics.render_prometheus())


if __name__ == "__main__":
    raise SystemExit(main())
