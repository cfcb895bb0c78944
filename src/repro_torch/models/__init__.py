"""The LM stack of the port: gemma3-style stacks of global and sliding-window
attention blocks, prefill and decode."""
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
