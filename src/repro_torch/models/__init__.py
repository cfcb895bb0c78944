"""The LM stack of the port: stacks of global and sliding-window attention
blocks (gemma3, llama3, qwen1.5, starcoder2), tied or untied heads,
prefill and decode; prefix K/V in attention for the serving engine."""
from .config import ATTN, ATTN_LOCAL, MOE, RGLRU, SSD, ModelConfig  # noqa: F401
from .model import (  # noqa: F401
    LM,
    decode_step,
    forward,
    greedy_sample,
    init_cache,
    init_lm,
    param_count,
    prefill,
)
