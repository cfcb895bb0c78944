"""llama3-405b [dense] — arXiv:2407.21783. GQA, 128k vocab, untied head.
The same shape as ``repro/configs/llama3_405b.py``."""
from ..models.config import ATTN, ModelConfig

ARCH_ID = "llama3-405b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=126,
        d_model=16_384,
        n_heads=128,
        n_kv_heads=8,
        head_dim=128,
        d_ff=53_248,
        vocab_size=128_256,
        block_pattern=(ATTN,) * 126,
        mlp_kind="swiglu",
        norm_kind="rmsnorm",
        rope_theta=500_000.0,
        tie_embeddings=False,
    )
