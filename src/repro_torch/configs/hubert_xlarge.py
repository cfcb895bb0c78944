"""hubert-xlarge [audio] — arXiv:2106.07447. Encoder-only transformer over
precomputed frame embeddings (the conv feature extractor is a STUB);
504-unit codebook head.
The same shape as ``repro/configs/hubert_xlarge.py``."""
from ..models.config import ATTN, ModelConfig

ARCH_ID = "hubert-xlarge"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=48,
        d_model=1_280,
        n_heads=16,
        n_kv_heads=16,
        head_dim=80,
        d_ff=5_120,
        vocab_size=504,
        block_pattern=(ATTN,) * 48,
        mlp_kind="gelu",
        norm_kind="layernorm",
        causal=False,
        frontend="audio",
        frontend_len=-1,  # -1: ALL positions come from the frame stub
        tie_embeddings=False,
    )
