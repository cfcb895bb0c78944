"""recurrentgemma-2b [hybrid] — arXiv:2402.19427 (Griffin: RG-LRU + local
attention, 1 attention per 2 recurrent blocks, MQA).
The same shape as ``repro/configs/recurrentgemma_2b.py``."""
from ..models.config import ATTN_LOCAL, RGLRU, ModelConfig

ARCH_ID = "recurrentgemma-2b"


def config() -> ModelConfig:
    period = (RGLRU, RGLRU, ATTN_LOCAL)
    return ModelConfig(
        name=ARCH_ID,
        n_layers=26,
        d_model=2_560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7_680,
        vocab_size=256_000,
        block_pattern=(period * 9)[:26],
        local_window=2_048,
        lru_width=2_560,
        conv_width=4,
        mlp_kind="geglu",
        norm_kind="rmsnorm",
        emb_scale=True,
        tie_embeddings=True,
    )
