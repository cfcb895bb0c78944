"""The layer stack: the port of ``repro/models/stack.py``.

The reference scans over the pattern's repeating period with parameters
stacked ``(n_periods, ...)`` per period position, to keep XLA's compile
time O(period).  PyTorch runs eagerly, so the port keeps the layers in a
``ModuleList`` in layer order; the period structure matters to the
weight conversion (``convert.lm_params_from_numpy``) and to training's
remat: ``forward_aux`` checkpoints each full period group, as the
reference's ``nothing_saveable`` policy does, and runs the tail plain.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .act_sharding import hint_decode, hint_residual
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
        self.cfg = cfg
        self.layers = nn.ModuleList(
            Block(cfg, kind, gen, device) for kind in cfg.block_pattern)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        p, n_full, _tail = find_period(self.cfg.block_pattern)
        x = hint_residual(x)
        for i, layer in enumerate(self.layers):
            x = layer(x, positions)
            if (i + 1) % p == 0 and i < n_full * p:
                x = hint_residual(x)
        return x

    def forward_aux(self, x: torch.Tensor, positions: torch.Tensor):
        """``(x', aux)``: the stack with the blocks' aux losses summed in
        the graph (float32; the reference's ``stack_forward``).  Each
        period group keeps only its input for the backward and is run
        again there (``torch.utils.checkpoint``, non-reentrant); the tail
        layers are not checkpointed."""
        p, n_full, _tail = find_period(self.cfg.block_pattern)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        def group(x, layers):
            a = torch.zeros((), dtype=torch.float32, device=x.device)
            for layer in layers:
                x, la = layer.forward_aux(x, positions)
                a = a + la
            return x, a

        def hinted(x, layers):
            x, a = group(x, layers)
            return hint_residual(x), a

        x = hint_residual(x)
        for i in range(n_full):
            layers = self.layers[i * p:(i + 1) * p]
            x, a = checkpoint(hinted, x, layers, use_reentrant=False,
                              preserve_rng_state=False)
            aux = aux + a
        x, a = group(x, self.layers[n_full * p:])
        return x, aux + a

    def decode(self, cache: list, x: torch.Tensor, t: int) -> torch.Tensor:
        p, n_full, _tail = find_period(self.cfg.block_pattern)
        for i, (layer, c) in enumerate(zip(self.layers, cache)):
            x = layer.decode(c, x, t)
            if (i + 1) % p == 0 and i < n_full * p:
                x = hint_decode(x)
        return x


def init_stack_cache(cfg, batch, max_len, dtype=torch.bfloat16, *,
                     device=None) -> list:
    """One cache per layer, in layer order, by the layer's kind: a ring
    buffer for attention, the recurrent state and conv history for
    ``ssd``/``rglru`` (recurrentgemma's 26 layers: 8 periods of R, R, A,
    then R, R)."""
    return [init_block_cache(cfg, kind, batch, max_len, dtype, device=device)
            for kind in cfg.block_pattern]
