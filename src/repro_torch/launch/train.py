"""Training entry point of the port:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --reduced --steps 20 --batch 8 --seq 128 --ckpt-dir DIR \
        [--accum 2 --lr 3e-4 --ckpt-every 10] [--device cpu]

The flags are the JAX package's (``repro.launch.train``) plus ``--device``
(default: the CUDA card). Rerun with the same ``--ckpt-dir`` to resume from
its latest checkpoint.

Distributed: ``--distributed`` starts a process group and trains
data-parallel over a (ranks, 1) ("data", "model") mesh, as the JAX CLI
does — one process per rank, NCCL on the cards or gloo with
``--device cpu``. The group's address comes from
torchrun's environment (``torchrun --nproc-per-node 4 -m
repro_torch.launch.train --distributed ...``) or from ``--coordinator
host:port --num-processes N --process-id I`` (as the JAX CLI takes them).
Rank 0 writes the checkpoints and prints the result.
"""
from __future__ import annotations

import argparse
import os


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

    mesh = None
    if args.distributed:
        import torch.distributed as dist
        from repro_torch.launch import mesh as mesh_lib
        if args.coordinator:
            addr = args.coordinator
            mesh_lib.init_distributed(
                addr if addr.startswith("tcp://") else f"tcp://{addr}",
                world_size=args.num_processes, rank=args.process_id,
                device=args.device)
        elif "RANK" in os.environ:
            mesh_lib.init_distributed("env://", device=args.device)
        else:
            raise SystemExit(
                "train: --distributed needs torchrun's environment (RANK, "
                "WORLD_SIZE, MASTER_ADDR, MASTER_PORT) or --coordinator "
                "host:port with --num-processes and --process-id")
        mesh = mesh_lib.make_host_mesh(data=dist.get_world_size(), model=1)
    try:
        return _train(args, mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _train(args, mesh) -> int:
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
    trainer = Trainer(cfg, tc, device=args.device, mesh=mesh)
    trainer.train()
    ppl = trainer.eval_ppl()
    if mesh is None or mesh.device_mesh.get_rank() == 0:
        print(f"final eval ppl: {ppl:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
