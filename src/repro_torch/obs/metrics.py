"""Minimal counter registry (port of the counter half of ``repro.obs.metrics``).

Enough for the one-round assertions of the engine: ``routing.dispatches``
ticks once per :func:`repro_torch.core.routing.dispatch` call,
``routing.collects`` once per reply leg, ``engine.rounds`` once per
executed engine round, ``surrogate.*`` with the provenance lanes of the
neighbourhood query.  Plain host integers in one process-wide table;
the full telemetry substrate (histograms, traces, skew, cost model) is a
later slice.  :func:`merge_wire_stats` combines the wire accounting of
several rounds as tensors, without touching the table.
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


def merge_wire_stats(*stats: dict) -> dict:
    """Combine per-round wire accounting: ``wire_words`` add, ``fill_frac``
    is weighted by each round's wire words.  With one argument the two
    lanes pass through untouched."""
    import torch

    if not stats:
        raise ValueError("merge_wire_stats needs at least one stats dict")
    if len(stats) == 1:
        s = stats[0]
        return {"wire_words": s["wire_words"], "fill_frac": s["fill_frac"]}
    words = [torch.as_tensor(s["wire_words"]) for s in stats]
    weights = [w.to(torch.float32) for w in words]
    total = torch.clamp(sum(weights[1:], weights[0]), min=1.0)
    fill = sum((s["fill_frac"] * w for s, w in zip(stats[1:], weights[1:])),
               stats[0]["fill_frac"] * weights[0])
    return {"wire_words": sum(words[1:], words[0]), "fill_frac": fill / total}
