"""The layer stack: the port of ``repro/models/stack.py``.

The reference scans over the pattern's repeating period with parameters
stacked ``(n_periods, ...)`` per period position, to keep XLA's compile
time O(period).  PyTorch runs eagerly, so the port keeps the layers in a
``ModuleList`` in layer order; the period structure matters only to the
weight conversion (``convert.lm_params_from_numpy``).
"""
from __future__ import annotations

import torch
from torch import nn

from .blocks import Block, init_block_cache


def find_period(pattern: tuple[str, ...]) -> tuple[int, int, int]:
    """(period, n_full_periods, tail_len) — smallest p with
    pattern[i] == pattern[i % p] for all i."""
    n = len(pattern)
    for p in range(1, n + 1):
        if all(pattern[i] == pattern[i % p] for i in range(n)):
            return p, n // p, n % p
    return n, 1, 0


class Stack(nn.Module):
    def __init__(self, cfg, gen: torch.Generator, device):
        super().__init__()
        self.layers = nn.ModuleList(
            Block(cfg, kind, gen, device) for kind in cfg.block_pattern)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, positions)
        return x

    def decode(self, cache: list, x: torch.Tensor, t: int) -> torch.Tensor:
        for layer, c in zip(self.layers, cache):
            x = layer.decode(c, x, t)
        return x


def init_stack_cache(cfg, batch, max_len, dtype=torch.bfloat16, *,
                     device=None) -> list:
    """One ring buffer per layer, in layer order."""
    return [init_block_cache(cfg, kind, batch, max_len, dtype, device=device)
            for kind in cfg.block_pattern]
