"""The LM stack of the port, every family of the JAX package: global and
sliding-window attention (gemma3, llama3, qwen1.5, starcoder2), MoE
(qwen3-moe, llama4-scout), Mamba-2 SSD (mamba2), RG-LRU with local
attention (recurrentgemma) and the frontend stubs (internvl2's patches,
hubert's frames, encoder-only); tied or untied heads, prefill and
decode; prefix K/V in attention for the serving engine; the train loss
(``loss_fn``)."""
from .config import ATTN, ATTN_LOCAL, MOE, RGLRU, SSD, ModelConfig  # noqa: F401
from .model import (  # noqa: F401
    IGNORE,
    LM,
    decode_step,
    forward,
    greedy_sample,
    init_cache,
    init_lm,
    loss_fn,
    param_count,
    prefill,
)
