"""gemma3-12b [dense] — hf:google/gemma-3 family. 5:1 local:global, 128k
context, 262k vocab, QK-norm, pre+post norms, scaled embeddings.  The
same shape as ``repro/configs/gemma3_12b.py``."""
from ..models.config import ATTN, ATTN_LOCAL, ModelConfig

ARCH_ID = "gemma3-12b"


def config() -> ModelConfig:
    period = (ATTN_LOCAL,) * 5 + (ATTN,)
    return ModelConfig(
        name=ARCH_ID,
        n_layers=48,
        d_model=3_840,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=15_360,
        vocab_size=262_144,
        block_pattern=period * 8,
        qk_norm=True,
        local_window=1_024,
        rope_theta=1_000_000.0,
        rope_theta_local=10_000.0,
        mlp_kind="geglu",
        norm_kind="rmsnorm",
        use_post_norm=True,
        emb_scale=True,
        tie_embeddings=True,
    )
