"""The port's optimizer: AdamW with schedules, clipping, int8/top-k
gradient compression and float32 masters; the int8 reduce-scatter over a
``torch.distributed`` group."""
from .adamw import AdamWConfig, apply_updates, init_opt_state, lr_at  # noqa: F401
