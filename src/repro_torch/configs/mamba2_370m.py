"""mamba2-370m [ssm] — arXiv:2405.21060 (SSD, attention-free).
The same shape as ``repro/configs/mamba2_370m.py``."""
from ..models.config import SSD, ModelConfig

ARCH_ID = "mamba2-370m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=48,
        d_model=1_024,
        n_heads=16,          # nominal (attention-free)
        n_kv_heads=16,
        head_dim=64,
        d_ff=0,
        vocab_size=50_280,
        block_pattern=(SSD,) * 48,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_conv=4,
        norm_kind="rmsnorm",
        tie_embeddings=True,
    )
