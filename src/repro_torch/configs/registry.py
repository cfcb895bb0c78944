"""Architecture registry of the port.  Only the architectures whose
blocks are ported resolve; the JAX package's other ids raise
``NotImplementedError`` until their blocks land (ROADMAP queue 1,
item 15)."""
from __future__ import annotations

from ..models.config import ModelConfig
from . import (
    gemma3_12b,
    llama3_405b,
    llama4_scout_17b_a16e,
    qwen1_5_32b,
    qwen3_moe_235b_a22b,
    starcoder2_3b,
)

ARCHS = {m.ARCH_ID: m for m in (llama3_405b, qwen1_5_32b, gemma3_12b,
                                 starcoder2_3b, llama4_scout_17b_a16e,
                                 qwen3_moe_235b_a22b)}
# the JAX package's other architectures (repro/configs/registry.py)
NOT_PORTED = ("mamba2-370m", "recurrentgemma-2b", "internvl2-26b",
              "hubert-xlarge")


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id}: not ported yet (ROADMAP queue 1, item 15)")
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id].config()
