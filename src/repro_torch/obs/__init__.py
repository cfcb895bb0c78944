"""Telemetry for the PyTorch port (counters only in this slice)."""
from . import metrics
from .metrics import counting, get, inc, reset

__all__ = ["metrics", "counting", "get", "inc", "reset"]
