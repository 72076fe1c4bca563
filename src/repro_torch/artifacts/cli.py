"""Artifact CLI of the port — the export / inspect / verify workflow of
``repro.artifacts``, with the same flags and defaults plus ``--device``:

    PYTHONPATH=src python -m repro_torch.artifacts export \
        --arch tinyllama-1.1b --reduced --method latmix-lu --fmt mxfp4 \
        --out artifacts/tinyllama-mxfp4              # on the card
    PYTHONPATH=src python -m repro_torch.artifacts export --device cpu ...

    PYTHONPATH=src python -m repro_torch.artifacts inspect artifacts/tinyllama-mxfp4
    PYTHONPATH=src python -m repro_torch.artifacts verify  artifacts/tinyllama-mxfp4

`export` runs the PTQ pipeline on random weights from ``--seed`` and
writes the packed artifact; `inspect` prints the manifest summary and
per-tensor layout; `verify` recomputes content hashes and cross-checks the
packed byte totals against the roofline accounting, exiting non-zero on
any mismatch. ``--ckpt-dir`` restores the latest training checkpoint there
(written by either package's trainer) in place of the random weights.
"""
from __future__ import annotations

import argparse
import sys


def _cmd_export(args) -> int:
    import time

    import torch

    from repro_torch import configs, devices
    from repro_torch.core import ptq
    from repro_torch.data import synthetic
    from repro_torch.models import api
    from repro_torch.training import checkpoint as ckpt

    from .store import export_artifact

    dev = devices.resolve(args.device)
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get(args.arch))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = api.init(gen, cfg, device=dev)
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        restored, man = ckpt.restore(args.ckpt_dir,
                                     {"params": params, "opt": None},
                                     device=dev)
        params = restored["params"]
        print(f"loaded checkpoint step {man['step']}")
    else:
        print("no checkpoint — random init (demo mode)")

    src = synthetic.make_source(cfg, args.calib_batch, args.calib_len, 0)
    calib = [src.batch(i) for i in range(args.calib_batches)]
    t0 = time.time()
    res = ptq.apply_method(args.method, params, cfg, calib, fmt=args.fmt,
                           steps=args.steps)
    print(f"PTQ [{args.method} / {args.fmt}] on {dev} in "
          f"{time.time() - t0:.0f}s")
    out = export_artifact(res, cfg, args.out)
    print(f"exported artifact -> {out}")
    return 0


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024
    return f"{n} B"


def _cmd_inspect(args) -> int:
    import pathlib

    from .manifest import MANIFEST_FILE, ArtifactError, Manifest

    try:
        man = Manifest.load(pathlib.Path(args.path) / MANIFEST_FILE)
    except ArtifactError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    a = man.arch
    print(f"artifact:    {args.path}")
    print(f"schema:      v{man.schema_version} ({man.kind})")
    print(f"method/fmt:  {man.method} / {man.fmt}")
    print(f"arch:        {a['name']} [{a['family']}] "
          f"L={a['n_layers']} d={a['d_model']} ff={a['d_ff']} "
          f"V={a['vocab_size']}")
    qmj = man.quant_mode
    act = qmj.get("act_cfg") or {}
    print(f"quant mode:  enabled={qmj['enabled']} "
          f"act={act.get('fmt')}/b{act.get('block_size')}"
          f"/{act.get('scale_mode')} t3_block={qmj['t3_block']} "
          f"quantize_head={qmj['quantize_head']}")
    print(f"packed:      {_fmt_bytes(man.packed_total_nbytes)} "
          f"in {sum(1 for t in man.tensors if t.kind == 'packed')} tensors")
    print(f"raw (fp):    {_fmt_bytes(man.raw_total_nbytes)} "
          f"in {sum(1 for t in man.tensors if t.kind == 'raw')} tensors")
    if args.tensors:
        print(f"\n{'tensor':32s} {'kind':7s} {'dtype':9s} "
              f"{'bytes':>12s}  shape")
        for t in man.tensors:
            nb = t.packed_nbytes if t.kind == "packed" else t.nbytes
            print(f"{t.key:32s} {t.kind:7s} {t.dtype:9s} "
                  f"{nb:>12d}  {tuple(t.shape)}")
    return 0


def _cmd_verify(args) -> int:
    from .manifest import ArtifactError
    from .store import verify_artifact

    try:
        rep = verify_artifact(args.path)
    except ArtifactError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(f"OK: {rep['n_tensors']} tensors, "
          f"{_fmt_bytes(rep['packed_nbytes'])} packed "
          f"({rep['method']} / {rep['fmt']}), hashes and roofline "
          f"byte accounting verified")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.artifacts",
        description="MX artifact store: export/inspect/verify packed "
                    "quantized checkpoints")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ex = sub.add_parser("export", help="run PTQ and export an artifact")
    ex.add_argument("--arch", default="tinyllama-1.1b")
    ex.add_argument("--reduced", action="store_true", default=True)
    ex.add_argument("--full", dest="reduced", action="store_false")
    ex.add_argument("--ckpt-dir", default="")
    ex.add_argument("--method", default="latmix-lu")
    ex.add_argument("--fmt", default="mxfp4", choices=["mxfp4", "mxint4"])
    ex.add_argument("--steps", type=int, default=60)
    ex.add_argument("--seed", type=int, default=0)
    ex.add_argument("--calib-batches", type=int, default=3)
    ex.add_argument("--calib-batch", type=int, default=8)
    ex.add_argument("--calib-len", type=int, default=64)
    ex.add_argument("--out", required=True)
    ex.add_argument("--device", default=None,
                    help="where the PTQ runs: the CUDA card by default, "
                         "'cpu' for the plain PyTorch versions")
    ex.set_defaults(func=_cmd_export)

    ins = sub.add_parser("inspect", help="print manifest summary")
    ins.add_argument("path")
    ins.add_argument("--tensors", action="store_true",
                     help="also print the per-tensor table")
    ins.set_defaults(func=_cmd_inspect)

    ver = sub.add_parser("verify", help="hash + byte-accounting check")
    ver.add_argument("path")
    ver.set_defaults(func=_cmd_verify)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
