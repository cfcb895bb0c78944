"""The port's training stack: the train step (remat, microbatches, data
parallelism over a ``torch.distributed`` group, compression, AdamW with
float32 masters) and the fault-tolerant loop."""
from .train_step import make_train_state, make_train_step  # noqa: F401
from .trainer import FailureInjector, TrainerConfig, run  # noqa: F401
