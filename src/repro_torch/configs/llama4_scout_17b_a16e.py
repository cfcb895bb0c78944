"""llama4-scout-17b-a16e [moe] — hf:meta-llama/Llama-4-Scout-17B-16E.
16 routed experts top-1 + 1 shared expert per layer.  The same shape as
``repro/configs/llama4_scout_17b_a16e.py``."""
from ..models.config import MOE, ModelConfig

ARCH_ID = "llama4-scout-17b-a16e"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=48,
        d_model=5_120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8_192,
        vocab_size=202_048,
        block_pattern=(MOE,) * 48,
        n_experts=16,
        experts_per_token=1,
        n_shared_experts=1,
        d_ff_expert=8_192,
        mlp_kind="swiglu",
        norm_kind="rmsnorm",
        rope_theta=500_000.0,
        tie_embeddings=False,
    )
