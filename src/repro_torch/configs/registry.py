"""Architecture registry of the port: ``--arch <id>`` resolution for every
launcher.  All ten architectures of the JAX package resolve, in its order
(``repro/configs/registry.py``): dense, hybrid local/global, SSM, RG-LRU,
frontend (vision, audio) and MoE families."""
from __future__ import annotations

from ..models.config import ModelConfig
from . import (
    gemma3_12b,
    hubert_xlarge,
    internvl2_26b,
    llama3_405b,
    llama4_scout_17b_a16e,
    mamba2_370m,
    qwen1_5_32b,
    qwen3_moe_235b_a22b,
    recurrentgemma_2b,
    starcoder2_3b,
)

_MODULES = (
    llama3_405b,
    qwen1_5_32b,
    gemma3_12b,
    starcoder2_3b,
    mamba2_370m,
    recurrentgemma_2b,
    internvl2_26b,
    llama4_scout_17b_a16e,
    qwen3_moe_235b_a22b,
    hubert_xlarge,
)

ARCHS: dict[str, object] = {m.ARCH_ID: m for m in _MODULES}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id].config()


def all_arch_ids() -> list[str]:
    return [m.ARCH_ID for m in _MODULES]
