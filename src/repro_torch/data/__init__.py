"""The port's data pipeline: deterministic sharded synthetic batches
(numpy, as in the reference) and their DHT-memoized preprocessing
(``data.memo``, on the port's table)."""
from .pipeline import DataConfig, ShardInfo, get_batch, reassign_straggler  # noqa: F401
