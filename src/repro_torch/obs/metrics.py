"""Minimal counter registry (port of the counter half of ``repro.obs.metrics``).

Enough for the one-round assertions of the engine: ``routing.dispatches``
ticks once per :func:`repro_torch.core.routing.dispatch` call,
``routing.collects`` once per reply leg, ``engine.rounds`` once per
executed engine round.  Plain host integers in one process-wide table;
the full telemetry substrate (histograms, traces, skew, cost model) is a
later slice.
"""
from __future__ import annotations

from collections import Counter

_COUNTERS: Counter[str] = Counter()


def inc(name: str, v: int = 1) -> None:
    _COUNTERS[name] += int(v)


def get(name: str) -> int:
    return _COUNTERS[name]


def reset() -> None:
    _COUNTERS.clear()


class counting:
    """Delta of a counter over a ``with`` block (default
    ``routing.dispatches``)."""

    def __init__(self, name: str = "routing.dispatches"):
        self.name = name
        self.delta = 0

    def __enter__(self) -> "counting":
        self._start = get(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        self.delta = get(self.name) - self._start
        return False
