"""The one-token serve step: decode plus greedy sampling (the port of
``repro/serving/serve_step.py``)."""
from __future__ import annotations

from ..models import decode_step, greedy_sample
from ..models.config import ModelConfig


def make_serve_step(cfg: ModelConfig):
    """serve_step(lm, cache, tokens (B,1), t) -> (next_tokens (B,), cache)."""

    def serve_step(lm, cache, tokens, t):
        logits, cache = decode_step(lm, cache, tokens, t)
        return greedy_sample(logits, cfg), cache

    return serve_step
