"""Roofline analysis of the port (the JAX package's ``repro.roofline.
analyze`` on H100 constants).

Hardware model (NVIDIA H100 SXM, the peaks of ``PERF.md`` §6's
``bound_ms``): 989e12 bf16 dense FLOP/s, 3.35e12 B/s HBM3, 450e9 B/s of
NVLink per direction. Terms per (arch × shape) on the single-pod (16, 16)
mesh, all per rank:

  compute    = FLOPs / 989e12
  memory     = HBM bytes accessed / 3.35e12
  collective = collective bytes / 450e9

The collective term is NVLink's: it holds only inside one 8-GPU NVLink
domain. A 256-rank mesh spans 32 such hosts, and its collectives that
cross hosts run over the network at a fraction of that rate, so the term
is a lower bound there.

The counts come from the port's dry run (``launch/dryrun.py``: one
rank's local ops of the step, run on fake tensors). Eager mode counts
every layer, but a full-depth run of DeepSeek-67B's 95 layers at 256
ranks costs minutes, so each cell runs two reduced-depth variants (L₁ and
L₂ layers) and extrapolates:  total = f(L₁) + (units − 1)·(f(L₂) −
f(L₁)), a "unit" being a layer (dense / moe / ssm / encoder / vlm) or a
(rec, rec, attn) super-block (hybrid; the rec tail is in both variants and
lands in the intercept). Each layer's eager work is the same, so the
extrapolation equals the direct count (a test holds them equal at 4
layers). Gradient accumulation runs in full in each variant (every
microbatch is counted), so nothing is scaled afterwards.

MODEL_FLOPS = 6·N·D (train) / 2·N·D (prefill & decode), N_active for
MoE — the "useful" fraction MODEL_FLOPS / counted FLOPs exposes remat /
attention / quantizer overhead. Bytes are the port's unfused eager
traffic (see ``launch/dryrun.py``), so the memory term is an upper bound
of a fused program's.

Analysis, not measurement: nothing here runs on a device.

Usage:
  PYTHONPATH=src python -m repro_torch.roofline.analyze --arch all \\
      --shape all [--out experiments/roofline_torch]
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import pathlib

from repro_torch import configs
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.launch import dryrun as dr

PEAK_FLOPS = 989e12       # H100 SXM bf16 dense tensor-core rate
HBM_BW = 3.35e12          # H100 SXM HBM3
LINK_BW = 450e9           # NVLink 4, per direction, one 8-GPU domain
MESH_SHAPE = (16, 16)     # the single-pod mesh, ("data", "model")


def _variant_layers(cfg):
    if cfg.family == "hybrid":
        # keep the rec tail in both variants: units = super-blocks
        tail = cfg.n_tail_rec
        return 3 + tail, 6 + tail, cfg.n_super_blocks
    return 1, 2, cfg.n_layers


def _count_variant(cfg, shape, quant, baked=False):
    """One reduced-depth variant's per-rank (flops, bytes, collective
    bytes, collectives, accum)."""
    rec = dr.run_counted(cfg, shape, False, quant, baked=baked,
                         mesh_shape=MESH_SHAPE)
    if rec["status"] != "ok":
        raise RuntimeError(rec["error"])
    coll = rec["collectives"]
    return (rec["flops_per_device"], rec["bytes_accessed_per_device"],
            float(sum(v["bytes"] for v in coll.values())), coll,
            rec.get("accum", 1))


def _cache_bytes(cfg, batch: int, seq: int) -> float:
    """Bytes of the decode cache (read once per step, ideally)."""
    if cfg.family == "ssm":
        return (cfg.n_layers * batch
                * (cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state * 4
                   + cfg.conv_dim * (cfg.conv_kernel - 1) * 2))
    if cfg.family == "hybrid":
        a = min(seq, cfg.window)
        return (cfg.n_super_blocks * batch * a * cfg.kv_dim * 2 * 2
                + cfg.n_rec_layers * batch * cfg.lru_width
                * (4 + 2 * (cfg.conv_kernel - 1)))
    return cfg.n_layers * batch * seq * cfg.kv_dim * 2 * 2


def model_flops(cfg, shape) -> float:
    """6·N·D (train) / 2·N·D (prefill, decode), N the active params."""
    n_param = cfg.param_count(active_only=True)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_param * B * S
    if shape.kind == "prefill":
        return 2.0 * n_param * B * S
    return 2.0 * n_param * B        # one token per sequence


def decode_fraction(cfg, shape, quant: bool, bytes_hbm: float,
                    n_dev: int) -> float:
    """Decode is bandwidth-bound by construction: the roofline fraction
    is the ideal bytes (params once + cache once) over the counted."""
    if quant:
        pbytes = cfg.param_count() * (4.25 / 8)   # packed 4-bit + scales
    else:
        pbytes = cfg.param_count() * 2            # bf16
    ideal = (pbytes + _cache_bytes(cfg, shape.global_batch,
                                   shape.seq_len)) / n_dev
    return ideal / max(bytes_hbm, 1.0)


def analyze_cell(arch: str, shape_name: str, quant: bool = True,
                 arch_cfg=None, label: str = "", baked: bool = False) -> dict:
    cfg0 = arch_cfg or configs.get(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg0, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": why}
    n_dev = MESH_SHAPE[0] * MESH_SHAPE[1]
    l1, l2, units = _variant_layers(cfg0)
    res = {}
    for tag, L in (("l1", l1), ("l2", l2)):
        cfg = dataclasses.replace(cfg0, n_layers=L)
        res[tag] = _count_variant(cfg, shape, quant, baked)

    def extrap(i):
        per_unit = res["l2"][i] - res["l1"][i]
        return res["l1"][i] + (units - 1) * per_unit

    flops, bytes_hbm, coll_bytes = extrap(0), extrap(1), extrap(2)
    terms = {"compute": flops / PEAK_FLOPS, "memory": bytes_hbm / HBM_BW,
             "collective": coll_bytes / LINK_BW}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg0, shape)
    model_flops_dev = mf / n_dev
    bound = max(terms.values())
    if shape.kind == "decode":
        roofline_frac = decode_fraction(cfg0, shape, quant, bytes_hbm, n_dev)
    else:
        roofline_frac = (model_flops_dev / PEAK_FLOPS) / max(bound, 1e-30)
    return {
        "arch": arch, "shape": shape_name, "status": "ok",
        "label": label or "baseline",
        "quant": bool(quant and shape.kind != "train"),
        "accum": res["l1"][4], "units": units,
        "flops_per_device": flops,
        "hbm_bytes_per_device": bytes_hbm,
        "collective_bytes_per_device": coll_bytes,
        "collectives_l2": res["l2"][3],
        "terms_s": terms,
        "dominant": dominant,
        "model_flops": mf,
        "useful_flops_ratio": model_flops_dev / max(flops, 1.0),
        "roofline_fraction": roofline_frac,
        "step_time_lower_bound_s": bound,
    }


def _grid_cell(arch, shape_name, *, reduced):
    cfg = (configs.get_reduced if reduced else configs.get)(arch)
    try:
        return analyze_cell(arch, shape_name, arch_cfg=cfg, baked=True)
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        return {"arch": arch, "shape": shape_name, "status": "failed",
                "error": f"{type(e).__name__}: {e}"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--reduced", action="store_true",
                    help="the smoke configs (seconds a cell)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in its own process")
    ap.add_argument("--out", default="experiments/roofline_torch")
    args = ap.parse_args(argv)
    from repro_torch.configs.base import ASSIGNED_SHAPES
    archs = configs.ARCH_IDS if args.arch == "all" else [
        configs.canonical(args.arch)]
    shapes = (list(ASSIGNED_SHAPES) if args.shape == "all"
              else [args.shape])
    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    rows = []
    cells = [(arch, shp) for arch in archs for shp in shapes]
    one = functools.partial(_grid_cell, reduced=args.reduced)
    for arch, shp, r, secs in dr._cells(cells, args.jobs, one):
        r["wall_s"] = round(secs, 1)
        rows.append(r)
        if r["status"] == "ok":
            print(f"{arch:22s} {shp:12s} dom={r['dominant']:10s} "
                  f"cmp={r['terms_s']['compute']*1e3:8.2f}ms "
                  f"mem={r['terms_s']['memory']*1e3:8.2f}ms "
                  f"col={r['terms_s']['collective']*1e3:8.2f}ms "
                  f"frac={r['roofline_fraction']:.3f} "
                  f"({r['wall_s']:.0f}s)", flush=True)
        else:
            print(f"{arch:22s} {shp:12s} {r['status']}: "
                  f"{r.get('reason', r.get('error', ''))[:80]}", flush=True)
        (outdir / f"{arch}__{shp}.json").write_text(json.dumps(r, indent=1))
    (outdir / "table.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
