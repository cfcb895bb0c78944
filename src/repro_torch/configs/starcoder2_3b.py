"""starcoder2-3b [dense] — arXiv:2402.19173. GQA kv=2, RoPE, LayerNorm,
QKV bias, GELU MLP.  The same shape as ``repro/configs/starcoder2_3b.py``."""
from ..models.config import ATTN, ModelConfig

ARCH_ID = "starcoder2-3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=30,
        d_model=3_072,
        n_heads=24,
        n_kv_heads=2,
        head_dim=128,
        d_ff=12_288,
        vocab_size=49_152,
        block_pattern=(ATTN,) * 30,
        qkv_bias=True,
        mlp_kind="gelu",
        norm_kind="layernorm",
        rope_theta=100_000.0,
        tie_embeddings=True,
    )
