"""Architecture registry of the port.  Only the architectures whose
blocks are ported resolve; the JAX package's other ids raise
``NotImplementedError`` until their blocks land (ROADMAP queue 1,
item 15)."""
from __future__ import annotations

from ..models.config import ModelConfig
from . import gemma3_12b

ARCHS = {gemma3_12b.ARCH_ID: gemma3_12b}
# the JAX package's other architectures (repro/configs/registry.py)
NOT_PORTED = ("llama3-405b", "qwen1.5-32b", "starcoder2-3b", "mamba2-370m",
              "recurrentgemma-2b", "internvl2-26b", "llama4-scout-17b-a16e",
              "qwen3-moe-235b-a22b", "hubert-xlarge")


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id}: not ported yet (ROADMAP queue 1, item 15)")
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id].config()
