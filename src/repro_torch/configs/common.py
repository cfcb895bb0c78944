"""Reduced smoke configs: the port's copy of ``reduced()`` from
``repro/configs/common.py`` (that module imports jax at its top)."""
from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig
from ..models.stack import find_period


def reduced(cfg: ModelConfig, n_layers: int | None = None) -> ModelConfig:
    """Same-family tiny config for CPU smoke tests."""
    p, _, tail = find_period(cfg.block_pattern)
    n = n_layers or min(cfg.n_layers, p + max(1, min(tail, p)))
    pattern = cfg.block_pattern[:n]
    kv = max(1, min(cfg.n_kv_heads, 2)) if cfg.n_kv_heads < cfg.n_heads else 4
    return dataclasses.replace(
        cfg,
        n_layers=n,
        block_pattern=pattern,
        d_model=64,
        n_heads=4,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=128,
        d_ff_expert=64 if cfg.d_ff_expert else 0,
        n_experts=min(cfg.n_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        vocab_size=512,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=8,
        ssm_chunk=8,
        lru_width=64 if cfg.lru_width else 0,
        local_window=16,
        frontend_len=(cfg.frontend_len if cfg.frontend_len < 0 else 8) if cfg.frontend else 0,
        rope_theta=10_000.0,
        rope_theta_local=10_000.0 if cfg.rope_theta_local else None,
        dtype="float32",
    )
