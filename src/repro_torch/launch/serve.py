"""Serving launcher: batched generation through the DHT prefix cache, the
port of ``repro/launch/serve.py`` (its flags and defaults, and
``--device``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-32b --reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b --reduced --device cpu

It runs on the card unless ``--device`` names another.  The engine serves
token prompts on homogeneous global-attention stacks, so an architecture
the reference's launcher cannot serve fails, naming why: an encoder-only
config (hubert-xlarge) here, a frontend config (internvl2-26b) at the
engine (F13 in ROADMAP.md), a periodic or recurrent stack (gemma3-12b,
mamba2-370m, recurrentgemma-2b) at its first prefill.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import all_arch_ids, get_config, reduced
from ..core.layout import resolve_device
from ..models import init_lm
from ..serving import Engine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=all_arch_ids())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, n_layers=4)
    if not cfg.has_decode:
        raise ValueError(f"{args.arch} is encoder-only: no decode step to serve")
    dev = resolve_device(args.device)
    lm = init_lm(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                 device=dev)
    eng = Engine(cfg, lm, max_len=args.prompt_len + args.max_new + 64,
                 page_size=32, pool_pages=512,
                 dtype=torch.float32 if args.reduced else torch.bfloat16,
                 device=dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(
        0, cfg.vocab_size, size=(args.batch, args.prompt_len)).astype(np.int32)
    for r in range(args.rounds):
        res = eng.generate(prompts, args.max_new)
        print(f"round {r}: prefill computed {res.prefill_tokens_computed} "
              f"cached {res.prefill_tokens_cached}; stats {res.cache_stats}")


if __name__ == "__main__":
    main()
