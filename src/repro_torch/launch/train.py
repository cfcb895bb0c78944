"""Training launcher: ``--arch <id>`` and the fault-tolerant loop, the
port of ``repro/launch/train.py`` (its flags and defaults, and
``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b --reduced --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b --reduced --steps 3 --device cpu

It runs on the card unless ``--device`` names another.  The reference
shards the full configs over a TPU mesh; one card holds a reduced config
or a cut depth (``--reduced``).
"""
from __future__ import annotations

import argparse

from ..configs import all_arch_ids, get_config, reduced
from ..data import DataConfig
from ..optim import AdamWConfig
from ..train import TrainerConfig, run


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=all_arch_ids())
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compression", default="none",
                    choices=("none", "int8", "topk"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                       total_steps=args.steps, compression=args.compression)
    tcfg = TrainerConfig(total_steps=args.steps, accum=args.accum,
                         checkpoint_every=max(args.steps // 3, 1),
                         checkpoint_dir=args.ckpt_dir, log_every=10)
    return run(cfg, dcfg, ocfg, tcfg, device=args.device)


if __name__ == "__main__":
    main()
