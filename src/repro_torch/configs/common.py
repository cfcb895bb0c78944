"""The assigned input shapes, per-shape input specs and reduced smoke
configs: the port's copy of ``repro/configs/common.py`` (that module
imports jax at its top).  Input specs are tensors on the ``meta`` device:
shapes and dtypes, no memory."""
from __future__ import annotations

import dataclasses

import torch

from ..models.config import ModelConfig
from ..models.stack import find_period


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

# archs allowed to run the long-context decode shape (sub-quadratic /
# local-attention families)
LONG_CONTEXT_ARCHS = {"mamba2-370m", "recurrentgemma-2b", "gemma3-12b"}


def applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch x shape) cell."""
    shape = SHAPES[shape_name]
    if shape.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only architecture: no autoregressive decode step"
    if shape_name == "long_500k" and cfg.name not in LONG_CONTEXT_ARCHS:
        return False, "pure full-attention architecture: 500k decode skipped per assignment"
    return True, ""


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """``meta`` tensors for every model input of this cell: ``tokens``
    and ``labels`` (train), ``tokens`` (prefill), each with
    ``frontend_embeds`` (B, F, E) in the config's type where the config
    has a frontend; decode: the bfloat16 ``cache`` of ``init_cache`` (a
    list of per-layer dicts), ``tokens`` (B, 1) and the position ``t``
    (an int32 scalar)."""
    from ..models.model import init_cache

    shape = SHAPES[shape_name]
    b, s = shape.batch, shape.seq
    i32 = torch.int32
    f = getattr(torch, cfg.dtype)
    fl = 0
    if cfg.frontend:
        fl = s if cfg.frontend_len < 0 else cfg.frontend_len
    s_text = s - fl

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        specs = {"tokens": meta((b, s_text), i32)}
        if shape.kind == "train":
            specs["labels"] = meta((b, s), i32)
        if cfg.frontend:
            specs["frontend_embeds"] = meta((b, fl, cfg.d_model), f)
        return specs

    # decode: one new token against a seq-long cache
    return {
        "cache": init_cache(cfg, b, s, torch.bfloat16, device="meta"),
        "tokens": meta((b, 1), i32),
        "t": meta((), i32),
    }


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
