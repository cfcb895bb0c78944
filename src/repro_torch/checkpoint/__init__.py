"""Checkpoints of the port in the reference's on-disk format, and the
resize of a DHT on restart (``rehash_dht``)."""
from .checkpoint import latest_step, rehash_dht, restore, save  # noqa: F401
