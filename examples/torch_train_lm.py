"""End-to-end training on the PyTorch port (twin of
``examples/train_lm.py``): a ~100M-parameter LM for a few hundred steps on
the synthetic pipeline, with checkpointing and restart.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300 [--device cpu]

A run that finds a checkpoint in ``--ckpt-dir`` resumes from it.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.data import DataConfig
from repro_torch.models import ATTN, param_count
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainerConfig, run


def model_100m():
    """A ~100M-param starcoder2-family config (same block structure)."""
    base = get_config("starcoder2-3b")
    return dataclasses.replace(
        base,
        n_layers=8,
        block_pattern=(ATTN,) * 8,
        d_model=768,
        n_heads=12,
        n_kv_heads=2,
        head_dim=64,
        d_ff=3072,
        vocab_size=32_000,
        dtype="float32",
    )


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train_lm"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = model_100m()
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
    ocfg = AdamWConfig(lr=6e-4, warmup_steps=30, total_steps=args.steps)
    tcfg = TrainerConfig(total_steps=args.steps, checkpoint_every=100,
                         checkpoint_dir=args.ckpt_dir, log_every=20)
    lm, opt, hist = run(cfg, dcfg, ocfg, tcfg, device=args.device)
    print(f"model: {cfg.name}-family, {param_count(lm)/1e6:.1f}M params")
    print(f"final loss: {hist[-1]['loss']:.4f} "
          f"(from {hist[0]['loss']:.4f} at step {hist[0]['step']})")
    return lm, opt, hist


if __name__ == "__main__":
    main()
