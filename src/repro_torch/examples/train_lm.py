"""End-to-end training: train a language model on the synthetic
corpus with the port's trainer (checkpointing, resume, grad accumulation).

Default is a CPU-friendly ~3M model for a few hundred steps; pass
``--preset 100m`` for the ~100M-parameter configuration (minutes on the
card):

    PYTHONPATH=src python -m repro_torch.examples.train_lm          # small
    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 100m
    PYTHONPATH=src python -m repro_torch.examples.train_lm \
        --arch tinyllama-1.1b --reduced --device cpu            # any arch
"""
import argparse

from repro_torch import configs
from repro_torch.configs.base import ArchConfig
from repro_torch.data.synthetic import DataConfig, unigram_ppl
from repro_torch.training import optimizer as opt
from repro_torch.training.trainer import TrainConfig, Trainer

PRESETS = {
    "small": (ArchConfig(name="lm-3m", family="dense", n_layers=4,
                         d_model=128, n_heads=8, n_kv_heads=4, head_dim=16,
                         d_ff=352, vocab_size=2048, attn_chunk=64),
              dict(steps=300, batch_size=16, seq_len=64, lr=3e-3)),
    "100m": (ArchConfig(name="lm-100m", family="dense", n_layers=12,
                        d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
                        d_ff=2048, vocab_size=32000, attn_chunk=256,
                        remat=True),
             dict(steps=300, batch_size=32, seq_len=512, lr=6e-4)),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="small", choices=list(PRESETS))
    ap.add_argument("--arch", default="")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.arch:
        cfg = (configs.get_reduced(args.arch) if args.reduced
               else configs.get(args.arch))
        hp = dict(steps=300, batch_size=8, seq_len=64, lr=1e-3)
    else:
        cfg, hp = PRESETS[args.preset]
    steps = args.steps or hp["steps"]
    n = cfg.param_count()
    print(f"training {cfg.name}: {n/1e6:.1f}M params, {steps} steps, "
          f"batch {hp['batch_size']}x{hp['seq_len']}")
    tc = TrainConfig(
        steps=steps, batch_size=hp["batch_size"], seq_len=hp["seq_len"],
        ckpt_every=max(50, steps // 4),
        ckpt_dir=args.ckpt_dir or f"checkpoints/{cfg.name}",
        log_every=20,
        opt=opt.AdamWConfig(lr=hp["lr"], warmup_steps=max(10, steps // 20),
                            total_steps=steps))
    tr = Trainer(cfg, tc, device=args.device)
    tr.train()
    ppl = tr.eval_ppl()
    base = unigram_ppl(DataConfig(cfg.vocab_size, hp["seq_len"],
                                  hp["batch_size"]))
    print(f"\nfinal held-out ppl: {ppl:.2f}  "
          f"(no-learning unigram baseline ≈ {base:.1f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
