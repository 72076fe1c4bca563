"""Training entry point of the port, on one device:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --reduced --steps 20 --batch 8 --seq 128 --ckpt-dir DIR \
        [--accum 2 --lr 3e-4 --ckpt-every 10] [--device cpu]

The flags are the JAX package's (``repro.launch.train``) plus ``--device``
(default: the CUDA card). Rerun with the same ``--ckpt-dir`` to resume from
its latest checkpoint. ``--distributed`` and its flags belong to the
parallel layouts (ROADMAP Queue 1 item 6) and are refused.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--coordinator", default="")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    args = ap.parse_args(argv)

    if args.distributed or args.num_processes != 1 or args.coordinator:
        raise SystemExit(
            "train: --distributed needs the port's parallel layouts "
            "(launch/mesh.py, shardings.py, pcontext.py), ROADMAP Queue 1 "
            "item 6; the port trains on one device")

    from repro_torch import configs
    from repro_torch.training import optimizer as opt
    from repro_torch.training.trainer import TrainConfig, Trainer

    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get(args.arch))
    tc = TrainConfig(
        steps=args.steps, batch_size=args.batch, seq_len=args.seq,
        accum=args.accum, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir,
        opt=opt.AdamWConfig(lr=args.lr, total_steps=args.steps))
    trainer = Trainer(cfg, tc, device=args.device)
    trainer.train()
    print(f"final eval ppl: {trainer.eval_ppl():.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
