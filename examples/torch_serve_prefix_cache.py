"""Serving with the DHT-backed prefix cache on the PyTorch port (twin of
``examples/serve_prefix_cache.py``): repeated and shared prompt prefixes
skip their prefill.  Batch 1 is cold, batch 2 shares a system prompt with
it, batch 3 repeats batch 2 and hits in full.

    PYTHONPATH=src python examples/torch_serve_prefix_cache.py [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.layout import resolve_device
from repro_torch.models import init_lm
from repro_torch.serving import Engine


def run(device: str = "cuda"):
    """The three batches on ``device``; returns their GenerationResults."""
    dev = resolve_device(device)
    cfg = reduced(get_config("llama3-405b"), n_layers=4)
    lm = init_lm(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                 device=dev)
    eng = Engine(cfg, lm, max_len=512, page_size=64, pool_pages=256,
                 dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)

    system_prompt = rng.integers(0, cfg.vocab_size, size=192)  # shared prefix

    def request_batch(n):
        tails = rng.integers(0, cfg.vocab_size, size=(n, 64))
        return np.concatenate(
            [np.tile(system_prompt, (n, 1)), tails], axis=1).astype(np.int32)

    def timed(label, prompts):
        t0 = time.perf_counter()
        r = eng.generate(prompts, 16)
        secs = time.perf_counter() - t0
        print(f"  computed {r.prefill_tokens_computed} cached "
              f"{r.prefill_tokens_cached} prefill tokens, {secs:.2f}s ({label})")
        return r

    print(f"device: {dev}")
    print("batch 1: cold (no cache)")
    r1 = timed("cold", request_batch(2))
    print("batch 2: same system prompt, new tails -> shared prefix hits")
    b2 = request_batch(2)
    r2 = timed("shared prefix", b2)
    print("batch 3: identical to batch 2 -> full-prompt hit, zero prefill")
    r3 = timed("full hit", b2)
    if not (r3.tokens == r2.tokens).all():
        raise SystemExit("cached generation must be identical")
    print("cache stats:", r3.cache_stats)
    return r1, r2, r3


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    run(ap.parse_args().device)


if __name__ == "__main__":
    main()
