"""Serving of the port: the DHT prefix-cache engine (prefix cache, KV
collecting prefill, greedy decode) and the one-token serve step."""
from .engine import Engine, GenerationResult  # noqa: F401
from .prefix_cache import PrefixCache  # noqa: F401
from .serve_step import make_serve_step  # noqa: F401
