"""Batched serving of an MX-quantized model: the deployment mode the paper
targets — LATMiX-folded weights, online T3 block-Hadamard, MX matmuls,
batched KV-cache decode — in the port, on the card.

    PYTHONPATH=src python -m repro_torch.examples.serve \
        [--quant mxfp4|off] [--batch 4] [--scheduler wave|continuous] \
        [--trace OUT.json] [--metrics] [--device cpu]

Pass --artifact DIR to skip PTQ and serve a packed artifact exported
earlier (``repro_torch.examples.latmix_ptq --export`` or ``python -m
repro_torch.artifacts export``; either package's): the weights stay 4-bit
packed and, on the card, go through the packed-GEMM kernel, and a
quantized ``--kv-cache`` through the attention kernels. Each lane's cache
holds the demo's longest request (at least 128 rows, as in the JAX
example): under ``--kv-layout paged`` that counts the page-long system
prompt, a whole attention chunk of an artifact with a long one.

--scheduler continuous switches the engine to continuous batching
(chunked prefill, per-slot decode positions) and demonstrates the
streaming submission API: requests are submitted one by one and tokens
stream back per step through ``Request.on_token`` while other requests
are still decoding.

--temperature/--top-k/--top-p sample instead of greedy argmax (seeded,
replayable); --spec-k K adds self-drafting speculative decoding on the
continuous scheduler — same tokens, fewer forwards.

--http HOST:PORT serves the engine over the HTTP/SSE front end instead of
the scripted demo (admission shedding via --max-queue-depth, SIGTERM
drains gracefully); stream tokens back with examples/client.py.
"""
import argparse
import json

import numpy as np
import torch

from repro_torch import devices
from repro_torch.artifacts import load_artifact
from repro_torch.configs.base import ArchConfig
from repro_torch.core import ptq
from repro_torch.core.quantize import QuantMode
from repro_torch.kernels import ops
from repro_torch.launch.serve import _obs_export
from repro_torch.models import api
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serving.engine import Engine, Request, default_page_size
from repro_torch.serving.policy import SchedulingPolicy, SpecConfig
from repro_torch.serving.sampling import SamplingParams


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quant", default="mxfp4",
                    choices=["mxfp4", "mxint4", "off"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new", type=int, default=24)
    ap.add_argument("--latmix", action="store_true",
                    help="learn+fold LATMiX transforms before serving")
    ap.add_argument("--artifact", default="",
                    help="serve a packed artifact directory (skips PTQ)")
    ap.add_argument("--eager", action="store_true",
                    help="with --artifact: dequantize all weights at load")
    ap.add_argument("--scheduler", default="wave",
                    choices=("wave", "continuous"),
                    help="static waves or continuous batching")
    ap.add_argument("--kv-cache", default="none",
                    choices=("none", "mxfp8", "mxint8", "mxfp4", "mxint4"),
                    help="MX-quantize the KV cache")
    ap.add_argument("--kv-layout", default="contiguous",
                    choices=("contiguous", "paged"),
                    help="page the KV cache through block tables with "
                         "prefix caching (continuous scheduler only)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="end-to-end TTL per request; expired requests "
                         "end TIMED_OUT")
    ap.add_argument("--ttft-deadline-ms", type=float, default=None,
                    help="time-to-first-token bound in milliseconds")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="preemptions a request survives before the "
                         "terminal PREEMPTED state")
    ap.add_argument("--no-preemption", dest="preemption",
                    action="store_false", default=True,
                    help="disable priority preemption under pool pressure")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature; 0 = greedy argmax")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k logit filter (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus (top-p) logit filter")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="base RNG seed; request i samples with seed+i")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding draft length (0 = off; "
                         "forces --scheduler continuous; outputs "
                         "unchanged)")
    ap.add_argument("--trace", default="", metavar="OUT.json",
                    help="export a Chrome trace of the run — open in "
                         "https://ui.perfetto.dev")
    ap.add_argument("--metrics", action="store_true",
                    help="record the kernel-dispatch metrics and print the "
                         "Prometheus metrics snapshot at exit")
    ap.add_argument("--http", default="", metavar="HOST:PORT",
                    help="serve over HTTP/SSE instead of the scripted "
                         "demo (SIGTERM drains; examples/client.py "
                         "streams tokens back)")
    ap.add_argument("--max-queue-depth", type=int, default=None,
                    help="with --http: shed (429 + Retry-After) past "
                         "this queue depth")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.kv_layout == "paged" or args.spec_k > 0:
        args.scheduler = "continuous"  # paged / spec are continuous-only
    if args.http:
        args.scheduler = "continuous"  # token streaming is per-slot
    args.policy = SchedulingPolicy(deadline_ms=args.deadline_ms,
                                   ttft_deadline_ms=args.ttft_deadline_ms,
                                   preemption=args.preemption,
                                   max_retries=args.max_retries,
                                   max_queue_depth=args.max_queue_depth)
    args.spec = SpecConfig(k=args.spec_k) if args.spec_k > 0 else None
    args.sampling = (SamplingParams(temperature=args.temperature,
                                    top_k=args.top_k, top_p=args.top_p,
                                    seed=args.sample_seed)
                     if (args.temperature > 0 or args.top_k > 0
                         or args.top_p < 1.0) else None)
    return args


def demo_max_len(cfg: ArchConfig, args) -> int:
    """KV cache rows a lane needs for :func:`run`'s traffic: the page-long
    system prompt under the paged layout, the longest tail and ``--new``
    tokens; at least the JAX example's 128."""
    sys_len = (default_page_size(cfg.attn_chunk)
               if args.kv_layout == "paged" else 0)
    return max(128, sys_len + 8 + 5 * (2 * args.batch - 1) + args.new)


def build_engine(args) -> Engine:
    """The engine the flags ask for: over ``--artifact``, or over the demo
    model quantized as ``--quant`` / ``--latmix`` say. Packed weights and
    a quantized KV cache take the fused backend: the CUDA kernels on the
    card, their plain versions on the CPU. With ``--metrics`` the kernel
    wrappers are instrumented (``ops.instrument``) into the engine's
    registry before anything runs; :func:`main` uninstruments them."""
    dev = devices.resolve(args.device)
    tracer = Tracer() if args.trace else None
    metrics = MetricsRegistry() if args.metrics else None
    if metrics is not None:          # kernel-dispatch hooks (kernels/ops.py)
        ops.instrument(metrics, tracer)
    if args.artifact:
        params, cfg, qm = load_artifact(args.artifact, eager=args.eager,
                                        device=dev)
        print(f"serving artifact {args.artifact} "
              f"({'eager' if args.eager else 'packed-lazy'} weights, "
              f"scheduler={args.scheduler}, device={dev})")
    else:
        cfg = ArchConfig(name="serve-demo", family="dense", n_layers=3,
                         d_model=128, n_heads=8, n_kv_heads=4, head_dim=16,
                         d_ff=352, vocab_size=512, attn_chunk=64)
        params = api.init(torch.Generator(device=dev).manual_seed(0), cfg,
                          device=dev)
        if args.quant == "off":
            qm = QuantMode.off()
        elif args.latmix:
            from repro_torch.data import synthetic
            src = synthetic.make_source(cfg, 8, 64, 0)
            calib = [src.batch(i) for i in range(2)]
            res = ptq.apply_method("latmix-lu", params, cfg, calib,
                                   fmt=args.quant, steps=60)
            params, qm = res.params, res.qm
            print("LATMiX transforms learned and folded.")
        else:
            qm = (QuantMode.mxfp4(t3=False) if args.quant == "mxfp4"
                  else QuantMode.mxint4(t3=False))
    return Engine(params, cfg, qm, batch_size=args.batch,
                  max_len=demo_max_len(cfg, args), backend="fused",
                  scheduler=args.scheduler, kv_cache=args.kv_cache,
                  kv_layout=args.kv_layout, metrics=metrics, tracer=tracer,
                  policy=args.policy, spec=args.spec, device=dev)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        eng = build_engine(args)
        if args.http:
            from repro_torch.serving.server import ServerConfig, serve
            host, _, port = args.http.rpartition(":")
            report = serve(eng, ServerConfig(host=host or "127.0.0.1",
                                             port=int(port or 8100)))
            print("drain report: " + json.dumps(report), flush=True)
            return 0 if report["clean"] else 1
        run(eng, args)
        _obs_export(eng, args)
        return 0
    finally:
        if args.metrics:
            ops.uninstrument()


def run(eng, args) -> dict:
    """The scripted demo: mixed-length traffic (streamed on the continuous
    scheduler), then a throughput wave. Returns the throughput record."""
    cfg = eng.cfg
    rng = np.random.default_rng(0)
    # mixed-length traffic: the regime where continuous batching wins.
    # Under --kv-layout paged every request shares a system prompt, so
    # the streaming demo shows prefix hits accumulating per admission.
    sys_prompt = (rng.integers(0, cfg.vocab_size, eng.page_size)
                  .astype(np.int32) if eng.kv_layout == "paged" else
                  np.zeros(0, np.int32))
    reqs = [Request(prompt=np.concatenate(
                [sys_prompt, rng.integers(0, cfg.vocab_size, 8 + 5 * i)
                 .astype(np.int32)]),
                    max_new=max(4, args.new - 3 * i),
                    sampling=(None if args.sampling is None else
                              SamplingParams(
                                  temperature=args.temperature,
                                  top_k=args.top_k, top_p=args.top_p,
                                  seed=args.sample_seed + i)))
            for i in range(args.batch * 2)]

    if eng.scheduler == "continuous":
        # streaming submission: enqueue everything, then step the
        # scheduler and watch tokens stream back per slot
        streamed = {i: [] for i in range(len(reqs))}
        done = []
        for i, r in enumerate(reqs):
            r.on_token = streamed[i].append
            eng.submit(r)
        while len(done) < len(reqs):
            done.extend(eng.step())   # one admission + decode step
        for i, r in enumerate(reqs):
            if list(r.out) != streamed[i]:
                raise RuntimeError(f"req{i}: streamed tokens differ from "
                                   f"its output")
            print(f"req{i}: prompt={len(r.prompt)}t -> streamed "
                  f"{len(streamed[i])} tokens, out[:6]={streamed[i][:6]}")
        if eng.kv_layout == "paged":
            st = eng.stats()
            print(f"paged KV: prefix_hit_tokens={st['prefix_hit_tokens']} "
                  f"blocks_in_use={st['blocks_in_use']} "
                  f"blocks_evicted={st['blocks_evicted']} "
                  f"kv_bytes_resident={eng.kv_bytes_resident()}")
    else:
        done = eng.generate(reqs)
        for i, r in enumerate(done):
            # m_* are the monotonic (perf_counter) stamps
            print(f"req{i}: prompt[-4:]={list(r.prompt[-4:])} "
                  f"-> out[:8]={list(r.out[:8])} "
                  f"({len(r.out)} tokens in {r.m_done-r.m_submit:.2f}s)")

    st = eng.stats()
    if any(v for k, v in st["terminal"].items() if k != "finished"):
        print("terminal states: " + ", ".join(
            f"{k}={v}" for k, v in st["terminal"].items() if v))
    if args.spec is not None:
        print(f"speculative decoding: {st['spec_proposed_tokens']} "
              f"drafted, {st['spec_accepted_tokens']} accepted "
              f"(acceptance {st['spec_acceptance']:.2f})")

    stats = eng.throughput(n_requests=args.batch, prompt_len=16,
                           max_new=args.new, sampling=args.sampling)
    src = (f"artifact {args.artifact}" if args.artifact
           else f"{args.quant}{' + LATMiX' if args.latmix else ''}")
    print(f"\nthroughput: {stats['tok_per_s']:.1f} tok/s ({src}, "
          f"scheduler={stats['scheduler']}, "
          f"kv_cache={stats['kv_cache']}, "
          f"decode utilization {stats['decode_utilization']:.2f}, "
          f"device={stats['device']})")
    if stats.get("ttft_p50") is not None:
        print(f"latency: ttft p50={stats['ttft_p50']*1e3:.1f}ms "
              f"p99={stats['ttft_p99']*1e3:.1f}ms")
    return stats


if __name__ == "__main__":
    raise SystemExit(main())
