"""Serving of the port: the one-token serve step.  The prefix-cache engine
is not ported yet (ROADMAP queue 1, item 15)."""
from .serve_step import make_serve_step  # noqa: F401
