"""qwen1.5-32b [dense] — hf:Qwen/Qwen1.5 family. QKV bias, untied head.
The same shape as ``repro/configs/qwen1_5_32b.py``."""
from ..models.config import ATTN, ModelConfig

ARCH_ID = "qwen1.5-32b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=64,
        d_model=5_120,
        n_heads=40,
        n_kv_heads=40,
        head_dim=128,
        d_ff=27_392,
        vocab_size=152_064,
        block_pattern=(ATTN,) * 64,
        qkv_bias=True,
        mlp_kind="swiglu",
        norm_kind="rmsnorm",
        rope_theta=1_000_000.0,
        tie_embeddings=False,
    )
