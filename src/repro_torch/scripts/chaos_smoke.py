"""CI chaos smoke: replay seeded fault scenarios against the port's
serving engine and validate the observable story end to end — the
exported trace must contain the preemption/timeout/cancel instants, the
metrics snapshot must carry the terminal-state counters, and quiescence
must leave zero leaked pages.

    PYTHONPATH=src python -m repro_torch.scripts.chaos_smoke [--device cpu]

Four scenarios, all deterministic (seeded injector + greedy decode):

1. lifecycle — a tight paged pool where a high-priority arrival
   preempts the running request, a zero-deadline request times out,
   and a queued request is cancelled; traced.
2. nan-isolation — a poisoned decode lane fails only its own request.
3. corruption — a truncated artifact tensor file is rejected with a
   descriptive IntegrityError, not a zip traceback.
4. server-supervisor — the HTTP front end's EngineSupervisor survives
   an injected step failure: the poisoned lane fails terminally, the
   bystander requeues and resumes bit-identically, an over-depth
   submit sheds loudly, and quiescence leaves zero leaked pages.

Exit 0 on success, 1 with a message on the first violated invariant.
"""
import argparse
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch import devices
from repro_torch.artifacts import (IntegrityError, export_artifact,
                                   load_artifact)
from repro_torch.artifacts.manifest import WEIGHTS_FILE
from repro_torch.configs.base import ArchConfig
from repro_torch.core import ptq
from repro_torch.core.quantize import QuantMode
from repro_torch.models import api
from repro_torch.obs import MetricsRegistry, Tracer, validate_trace
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.faults import FaultInjector, corrupt_file
from repro_torch.serving.policy import (RequestState, SchedulingPolicy,
                                        ShedError)
from repro_torch.serving.server import EngineSupervisor

CFG = ArchConfig(name="chaos", family="dense", n_layers=2, d_model=64,
                 n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                 attn_chunk=16)


def check(cond, message) -> None:
    """An invariant of a scenario (kept under ``python -O`` too)."""
    if not cond:
        raise AssertionError(message)


def _req(n, new, seed, **kw):
    rng = np.random.default_rng(seed)
    return Request(prompt=rng.integers(0, CFG.vocab_size, n)
                   .astype(np.int32), max_new=new, **kw)


def _engine(params, device, **kw):
    return Engine(params, CFG, QuantMode.off(), batch_size=2, max_len=64,
                  scheduler="continuous", device=device, **kw)


def scenario_lifecycle(params, device=None):
    tracer, metrics = Tracer(), MetricsRegistry()
    eng = _engine(params, device, kv_layout="paged", page_size=32,
                  n_pages=3, policy=SchedulingPolicy(backoff_base_s=0.001),
                  faults=FaultInjector(seed=0).inject("slow_step", every=6,
                                                      delay_s=0.001),
                  metrics=metrics, tracer=tracer)
    # lo fills the pool (far-future deadline caps its bursts so it is
    # mid-flight when hi arrives); hi preempts it; doomed times out;
    # parked is cancelled while queued.
    lo = _req(40, 10, seed=7, priority=0, deadline_ms=1e7)
    eng.submit(lo)
    eng.step()
    check(lo.state is RequestState.RUNNING, "lo never started")
    hi = _req(38, 8, seed=8, priority=5)
    doomed = _req(10, 4, seed=9, deadline_ms=0.0)
    parked = _req(12, 4, seed=10, deadline_ms=1e7)
    for r in (hi, doomed, parked):
        eng.submit(r)
    check(eng.cancel(parked.request_id), "cancel of queued request failed")
    steps = 0
    while eng.busy:
        eng.step()
        steps += 1
        check(steps < 500, "no quiescence")
        eng._alloc.check()

    st = eng.stats()
    check(lo.state is RequestState.FINISHED and lo.preemptions >= 1,
          f"lo: {lo.state}, {lo.preemptions} preemptions")
    check(hi.state is RequestState.FINISHED, f"hi: {hi.state}")
    check(doomed.state is RequestState.TIMED_OUT, f"doomed: {doomed.state}")
    check(parked.state is RequestState.CANCELLED, f"parked: {parked.state}")
    check(sum(st["terminal"].values()) == st["submitted"] == 4,
          f"terminal {st['terminal']} against {st['submitted']} submitted")
    check(st["preemptions"] >= 1, "no preemption")
    check(st["blocks_in_use"] == 0, "leaked pages")
    eng._alloc.check()

    with tempfile.TemporaryDirectory() as td:
        evs = validate_trace(eng.tracer.export(f"{td}/chaos_trace.json"))
    names = [e["name"] for e in evs]
    for needle in ("preempt", "timeout", "cancel"):
        check(needle in names, f"trace is missing the {needle!r} instant")
    snap = metrics.snapshot()
    got = {s["labels"]["state"]: s["value"]
           for s in snap["serving_requests_terminal_total"]}
    check(got.get("finished") == 2 and got.get("timed_out") == 1
          and got.get("cancelled") == 1, f"terminal counters wrong: {got}")
    check(snap["serving_preemptions_total"][0]["value"] >= 1,
          "no preemption counted")
    print(f"lifecycle OK: {len(evs)} trace events, terminal={got}, "
          f"{st['preemptions']} preemptions, 0 leaked pages")


def scenario_nan_isolation(params, device=None):
    eng = _engine(params, device,
                  faults=FaultInjector(seed=0).inject("nan_logits", at=1,
                                                      lane=0))
    victim, bystander = _req(16, 6, seed=20), _req(24, 6, seed=21)
    ref = _engine(params, device)
    ref_out = ref.generate([_req(24, 6, seed=21)])[0].out
    eng.submit(victim)
    eng.submit(bystander)
    eng.drain()
    check(victim.state is RequestState.FAILED, f"victim: {victim.state}")
    check("non-finite" in victim.error, victim.error)
    check(bystander.state is RequestState.FINISHED,
          f"bystander: {bystander.state}")
    check(list(bystander.out) == list(ref_out),
          "bystander differs from the fault-free run")
    trips = eng.stats()["nan_guard_trips"]
    check(trips == 1, f"{trips} NaN-guard trips")
    print(f"nan-isolation OK: victim failed ({victim.error!r}), "
          f"bystander bit-identical to fault-free run")


def scenario_corruption(params, device=None):
    calib_rng = np.random.default_rng(0)
    calib = [{"inputs": calib_rng.integers(0, CFG.vocab_size, (2, 32))}]
    res = ptq.apply_method("rtn", params, CFG, calib, fmt="mxfp4")
    with tempfile.TemporaryDirectory() as td:
        art = pathlib.Path(td) / "art"
        export_artifact(res, CFG, art)
        load_artifact(art, device=device)          # sanity: loads clean
        corrupt_file(art / WEIGHTS_FILE, mode="truncate", seed=1,
                     within=art)
        try:
            load_artifact(art, device=device)
        except IntegrityError as e:
            check("corrupt or truncated" in str(e), str(e))
            print(f"corruption OK: descriptive IntegrityError ({e})")
        else:
            raise AssertionError("truncated artifact loaded silently")


def scenario_server_supervisor(params, device=None):
    metrics = MetricsRegistry()
    fi = FaultInjector(seed=0).inject("failed_step", at=2, lane=0)
    paged = dict(kv_layout="paged", page_size=32, n_pages=6)
    eng = _engine(params, device,
                  policy=SchedulingPolicy(deadline_ms=1e9,  # burst cap on
                                          max_queue_depth=2),
                  metrics=metrics, **paged)
    # fault-free twin for the bit-identical-resume assertion
    ref = _engine(params, device, **paged)
    victim = _req(16, 12, seed=30)
    bystander = _req(24, 12, seed=31)
    ref_out = ref.generate([_req(24, 12, seed=31)])[0].out

    sup = EngineSupervisor(eng, faults=fi, worker_poll_s=0.005)
    # every submit lands before the worker starts: a running worker could
    # admit the victim first, and the third submit would then not shed
    sup.submit(victim)               # -> lane 0: blamed on the 3rd step
    sup.submit(bystander)            # -> lane 1: requeued, then resumed
    try:
        sup.submit(_req(8, 4, seed=32))
    except ShedError as e:
        shed = e.request
    else:
        raise AssertionError("over-depth submit was not shed")
    sup.start()
    try:
        deadline = time.monotonic() + 30
        while not sup.idle():
            check(time.monotonic() < deadline, "supervisor never quiesced")
            time.sleep(0.01)
    finally:
        sup.stop()

    check(victim.state is RequestState.FAILED, f"victim: {victim.state}")
    check("supervisor" in victim.error, victim.error)
    check(bystander.state is RequestState.FINISHED,
          f"bystander: {bystander.state}")
    check(list(bystander.out) == list(ref_out),
          "bystander differs from the fault-free run")
    check(shed.state is RequestState.SHED, f"shed: {shed.state}")
    check(sup.restarts == 1, f"{sup.restarts} restarts")
    st = sup.stats()
    check(sum(st["terminal"].values()) == st["submitted"] == 3, str(st))
    check(st["blocks_in_use"] == 0, "leaked pages")
    eng._alloc.check()
    snap = metrics.snapshot()
    check(snap["serving_requests_shed_total"][0]["value"] == 1, "shed count")
    check(snap["serving_supervisor_restarts_total"][0]["value"] == 1,
          "restart count")
    print(f"server-supervisor OK: victim failed ({victim.error!r}), "
          f"bystander resumed bit-identically after restart, 1 shed, "
          f"0 leaked pages")


SCENARIOS = (scenario_lifecycle, scenario_nan_isolation,
             scenario_corruption, scenario_server_supervisor)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = devices.resolve(args.device)
    params = api.init(torch.Generator(device=dev).manual_seed(0), CFG,
                      device=dev)
    try:
        for scenario in SCENARIOS:
            scenario(params, dev)
    except AssertionError as e:
        print(f"chaos smoke FAILED: {e}", file=sys.stderr)
        return 1
    print(f"chaos smoke: all scenarios green on {dev}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
