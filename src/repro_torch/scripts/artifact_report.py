"""Summarize exported MX artifacts: packed footprint against the fp16/fp32
equivalent, per artifact directory (the deployment-side view of the
roofline's weight-traffic reduction) — over the port's copy of the
manifest, for artifacts either package exported.

    PYTHONPATH=src python -m repro_torch.scripts.artifact_report \
        artifacts/ [more dirs]

Each argument may be an artifact directory (contains manifest.json) or a
parent directory scanned one level deep.
"""
import pathlib
import sys

import torch

from repro_torch.artifacts.manifest import (MANIFEST_FILE, ArtifactError,
                                            Manifest)


def _find(paths):
    for p in map(pathlib.Path, paths):
        if (p / MANIFEST_FILE).exists():
            yield p
        elif p.is_dir():
            for c in sorted(p.iterdir()):
                if (c / MANIFEST_FILE).exists():
                    yield c


def _itemsize(dtype: str) -> int:
    """Bytes of one element of the logical dtype named in a manifest
    (bfloat16 included, which numpy does not name)."""
    return getattr(torch, dtype).itemsize


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    roots = list(_find(argv or ["artifacts"]))
    if not roots:
        print("no artifact directories found", file=sys.stderr)
        return 1
    print(f"{'artifact':40s} {'method':14s} {'fmt':7s} "
          f"{'packed MiB':>10s} {'fp MiB':>8s} {'ratio':>6s}")
    for root in roots:
        try:
            man = Manifest.load(root / MANIFEST_FILE)
        except ArtifactError as e:
            print(f"{str(root):40s} SKIP ({e})")
            continue
        packed = man.packed_total_nbytes
        # fp equivalent of the quantized tensors, at their logical dtype
        fp = 0
        for t in man.tensors:
            if t.kind == "packed":
                n = 1
                for s in t.shape:
                    n *= int(s)
                fp += n * _itemsize(t.dtype)
        print(f"{str(root):40s} {man.method:14s} {man.fmt:7s} "
              f"{packed/2**20:10.2f} {fp/2**20:8.2f} "
              f"{fp/max(packed,1):5.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
