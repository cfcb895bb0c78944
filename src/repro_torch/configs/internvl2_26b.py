"""internvl2-26b [vlm] — arXiv:2404.16821. InternLM2-20B backbone; the
InternViT frontend is a STUB: input_specs supplies precomputed patch
embeddings as a 1024-position prefix.
The same shape as ``repro/configs/internvl2_26b.py``."""
from ..models.config import ATTN, ModelConfig

ARCH_ID = "internvl2-26b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=48,
        d_model=6_144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16_384,
        vocab_size=92_553,
        block_pattern=(ATTN,) * 48,
        mlp_kind="swiglu",
        norm_kind="rmsnorm",
        rope_theta=1_000_000.0,
        frontend="vision",
        frontend_len=1_024,
        tie_embeddings=False,
    )
