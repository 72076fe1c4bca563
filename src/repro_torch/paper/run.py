"""Runner of the paper's experiments in the port — one function per table
or figure, the JAX runner's (``benchmarks/run.py``) step counts, with and
without ``--fast``. Prints ``name,us_per_call,derived`` CSV; each table's
full rows go to ``--out`` (default ``experiments/torch_paper/``).

    PYTHONPATH=src python -m repro_torch.paper.run [--only fig2,table1]
        [--fast] [--device cpu] [--out DIR]
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

from repro_torch import devices


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="",
                    help="comma-separated subset: fig2,table1,table2,"
                         "table3,table8")
    ap.add_argument("--fast", action="store_true",
                    help="fewer transform-learning steps")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default="",
                    help="directory of the JSON rows (default "
                         "experiments/torch_paper)")
    args = ap.parse_args(argv)
    wanted = set(args.only.split(",")) if args.only else None
    dev = devices.resolve(args.device)

    from . import (common, fig2_mse, table1_methods, table2_granularity,
                   table3_invariance, table8_ablations)
    if args.out:
        common.OUT_DIR = pathlib.Path(args.out)

    benches = [
        ("fig2", fig2_mse.run, {}),
        ("table1", table1_methods.run,
         {"steps": 40} if args.fast else {}),
        ("table2", table2_granularity.run,
         {"steps": 40} if args.fast else {}),
        ("table3", table3_invariance.run, {}),
        ("table8", table8_ablations.run,
         {"steps": 30} if args.fast else {}),
    ]
    if wanted and not wanted <= {n for n, _, _ in benches}:
        ap.error(f"unknown --only entries: {sorted(wanted - {n for n, _, _ in benches})}")
    print("name,us_per_call,derived")
    t0 = time.time()
    for name, fn, kw in benches:
        if wanted and name not in wanted:
            continue
        print(f"# --- {name} ---", file=sys.stderr)
        t1 = time.time()
        fn(log=lambda m: print(m, file=sys.stderr), device=dev, **kw)
        common.sync()
        print(f"# {name} {time.time()-t1:.1f}s on {dev}", file=sys.stderr)
    print(f"# total {time.time()-t0:.0f}s", file=sys.stderr)


if __name__ == "__main__":
    main()
