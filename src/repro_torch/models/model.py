"""Language-model assembly: embeddings -> layer stack -> head, prefill and
the decode step.  The port of ``repro/models/model.py`` for stacks of
``attn``/``attn_local`` blocks.

Weights: every matrix is stored once in the working type ``cfg.dtype``
(the reference keeps float32 and casts at every use: the same numbers);
norm scales stay float32; the embedding table stays float32 because the
reference scales the looked-up rows before the cast, and the tied head
is a working-type copy of it made once (a buffer, not a parameter).
Parameters are random, drawn from the caller's ``torch.Generator``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..core.layout import resolve_device
from .config import ModelConfig
from .layers import embed, init_norm, norm, unembed
from .stack import Stack, init_stack_cache


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        if not cfg.tie_embeddings or cfg.frontend:
            raise NotImplementedError(
                "untied heads and modality frontends are not ported yet "
                "(ROADMAP queue 1, item 15)")
        self.cfg = cfg
        table = torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen,
                            dtype=torch.float32, device=device).mul_(0.02)
        self.embed = nn.Parameter(table, requires_grad=False)
        self.stack = Stack(cfg, gen, device)
        self.final_norm = init_norm(cfg.d_model, device, cfg.norm_kind)
        self.register_buffer("head", None, persistent=False)
        self.refresh_head()

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    def refresh_head(self) -> None:
        """The tied head: the embedding table in the working type (call
        again after the table changes)."""
        self.head = self.embed.detach().to(self.dtype)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return unembed(self.head, norm(self.final_norm, x, self.cfg.norm_kind))


def init_lm(cfg: ModelConfig, *, generator: torch.Generator,
            device: str | torch.device | None = None) -> LM:
    """A model with random parameters from ``generator`` (which must live
    on ``device``), on the card unless ``device`` names another."""
    dev = resolve_device(device)
    with torch.no_grad():
        return LM(cfg, generator, dev)


def _embed_inputs(lm: LM, batch) -> torch.Tensor:
    """Token embeddings, scaled by sqrt(d_model) in float32 when the
    config asks, then cast to the working type."""
    return embed(lm.embed, batch["tokens"], scale=lm.cfg.emb_scale).to(lm.dtype)


@torch.no_grad()
def forward(lm: LM, batch) -> torch.Tensor:
    """batch["tokens"]: (B, S) int -> logits (B, S, V_pad)."""
    x = _embed_inputs(lm, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    return lm.logits(lm.stack(x, positions))


@torch.no_grad()
def prefill(lm: LM, batch) -> torch.Tensor:
    """Logits (B, V_pad) of the last prompt position, to seed decode.  As
    in the reference, no cache is filled (serving fills it through the
    prefix cache).  Only the last position goes through the head: the
    head and the final norm act per position, so the numbers are
    ``forward(...)[:, -1]``."""
    x = _embed_inputs(lm, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    return lm.logits(lm.stack(x, positions)[:, -1])


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device=None) -> list:
    if not cfg.has_decode:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    return init_stack_cache(cfg, batch, max_len, dtype,
                            device=resolve_device(device))


@torch.no_grad()
def decode_step(lm: LM, cache: list, tokens: torch.Tensor, t: int):
    """One decode step.  tokens: (B, 1) int; t: absolute position.
    Returns (logits (B, V_pad), cache), the cache updated in place."""
    x = embed(lm.embed, tokens, scale=lm.cfg.emb_scale).to(lm.dtype)
    x = lm.stack.decode(cache, x, int(t))
    return lm.logits(x)[:, 0], cache


def greedy_sample(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """argmax over the real vocabulary (the padded tail is masked)."""
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -math.inf)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def param_count(lm: LM) -> int:
    """Parameters held (the tied head's copy is not one)."""
    return sum(p.numel() for p in lm.parameters())
