"""qwen3-moe-235b-a22b [moe] — hf:Qwen/Qwen3 MoE family. 128 experts
top-8, QK-norm, no shared expert.  The same shape as
``repro/configs/qwen3_moe_235b_a22b.py``."""
from ..models.config import MOE, ModelConfig

ARCH_ID = "qwen3-moe-235b-a22b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=94,
        d_model=4_096,
        n_heads=64,
        n_kv_heads=4,
        head_dim=128,
        d_ff=1_536,
        vocab_size=151_936,
        block_pattern=(MOE,) * 94,
        n_experts=128,
        experts_per_token=8,
        d_ff_expert=1_536,
        qk_norm=True,
        mlp_kind="swiglu",
        norm_kind="rmsnorm",
        rope_theta=1_000_000.0,
        tie_embeddings=False,
    )
