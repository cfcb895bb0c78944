"""Metric registry: named counters, gauges and fixed-bucket histograms
(PyTorch port of ``repro.obs.metrics``).

The engine's rounds accumulate into **stat lanes**: the ``estats`` dict
that ``op_engine.dht_execute`` returns and ``distributed.ReducedStats``
reduces over a process group.  Host code (the engine's commit half, the
``ShardedDHT`` wrappers, the migration and repair loops) flushes those
lanes into the process-local registry through
``obs.trace.record_round``, so the registry sees exactly the numbers the
caller sees.  Cross-process aggregation is a plain
:func:`merge_snapshots` over per-rank JSON snapshots.

Everything here is plain Python on the host: no tensor is stored.  The
one tensor helper is :func:`merge_wire_stats`, which combines the wire
accounting of several rounds as tensors and never sees the registry.

``OBS_DISABLED=1`` in the environment (or :func:`set_enabled`) turns the
whole substrate into no-ops.  The histogram arithmetic is the
reference's (``total += v``, ``merge`` adds the totals), so a snapshot
built in the same order is the reference's bit for bit; a merged float
``sum`` depends on the merge order in its last bits, like the
reference's.
"""
from __future__ import annotations

import bisect
import json
import os
from typing import Iterable, Sequence

__all__ = [
    "Histogram", "MetricRegistry", "get_registry", "set_registry",
    "enabled", "set_enabled", "disabled", "inc", "observe", "set_gauge",
    "counter_value", "counting", "merge_wire_stats", "merge_snapshots",
    "histogram_quantile", "LATENCY_EDGES_US", "FRACTION_EDGES",
    "SIZE_EDGES", "RATIO_EDGES",
]

# Fixed bucket lattices.  Fixed edges are what make histogram merge a
# plain elementwise count addition — associative and commutative by
# construction, so per-shard histograms union in any order.
LATENCY_EDGES_US: tuple[float, ...] = tuple(
    float(m * 10 ** e) for e in range(8) for m in (1, 2, 5))       # 1µs..50s
FRACTION_EDGES: tuple[float, ...] = tuple(i / 20 for i in range(1, 21))
SIZE_EDGES: tuple[float, ...] = tuple(float(1 << i) for i in range(25))
# ratios >= 1 (imbalance max/mean, p99/p50): dense near 1, 1-2-5 above
RATIO_EDGES: tuple[float, ...] = (
    1.0, 1.1, 1.25, 1.5, 1.75, 2.0, 2.5, 3.0, 4.0, 5.0, 6.0, 8.0,
    10.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0, 1024.0)

_ENABLED = os.environ.get("OBS_DISABLED", "0") not in ("1", "true", "yes")


def enabled() -> bool:
    """Is telemetry recording on? (``OBS_DISABLED=1`` starts it off.)"""
    return _ENABLED


def set_enabled(on: bool) -> bool:
    """Toggle recording; returns the previous state (for restore)."""
    global _ENABLED
    prev, _ENABLED = _ENABLED, bool(on)
    return prev


class disabled:
    """``with obs.metrics.disabled(): ...`` — recording off in the block."""

    def __enter__(self):
        self._prev = set_enabled(False)
        return self

    def __exit__(self, *exc):
        set_enabled(self._prev)
        return False


class Histogram:
    """Fixed-bucket histogram: ``edges`` are ascending bucket upper
    bounds; value v lands in the first bucket with ``v <= edge`` (one
    overflow bucket past the last edge).  Tracks sum/count/min/max for
    exact means alongside the bucketed shape."""

    __slots__ = ("edges", "counts", "total", "count", "vmin", "vmax")

    def __init__(self, edges: Sequence[float] = LATENCY_EDGES_US):
        self.edges = tuple(float(e) for e in edges)
        self.counts = [0] * (len(self.edges) + 1)
        self.total = 0.0
        self.count = 0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.total += v
        self.count += 1
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def merge(self, other: "Histogram") -> "Histogram":
        """Pure merge (self unchanged).  Elementwise count addition —
        associative and commutative because the edges are fixed."""
        if self.edges != other.edges:
            raise ValueError("cannot merge histograms with different edges")
        out = Histogram(self.edges)
        out.counts = [a + b for a, b in zip(self.counts, other.counts)]
        out.total = self.total + other.total
        out.count = self.count + other.count
        out.vmin = min(self.vmin, other.vmin)
        out.vmax = max(self.vmax, other.vmax)
        return out

    def to_dict(self) -> dict:
        return {
            "edges": list(self.edges),
            "counts": list(self.counts),
            "sum": self.total,
            "count": self.count,
            "min": self.vmin if self.count else None,
            "max": self.vmax if self.count else None,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Histogram":
        h = cls(d["edges"])
        h.counts = [int(c) for c in d["counts"]]
        h.total = float(d["sum"])
        h.count = int(d["count"])
        h.vmin = float("inf") if d.get("min") is None else float(d["min"])
        h.vmax = float("-inf") if d.get("max") is None else float(d["max"])
        return h


def histogram_quantile(h: dict | Histogram, q: float) -> float:
    """Approximate quantile from a (possibly snapshotted) histogram: the
    upper edge of the bucket holding the q-th observation."""
    d = h.to_dict() if isinstance(h, Histogram) else h
    count = int(d["count"])
    if count == 0:
        return 0.0
    target = max(1, int(q * count + 0.5))
    seen = 0
    for i, c in enumerate(d["counts"]):
        seen += int(c)
        if seen >= target:
            edges = d["edges"]
            return float(edges[i]) if i < len(edges) else float(d["max"])
    return float(d["max"])


class MetricRegistry:
    """Process-local named metrics.  Snapshots are deterministic (sorted
    keys, plain JSON types) so equal histories produce equal JSON."""

    def __init__(self):
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, Histogram] = {}

    # -- write side --------------------------------------------------
    def inc(self, name: str, v: int = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + int(v)

    def set_gauge(self, name: str, v: float) -> None:
        self._gauges[name] = float(v)

    def observe(self, name: str, value: float,
                edges: Sequence[float] = LATENCY_EDGES_US) -> None:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(edges)
        h.observe(value)

    # -- read side ---------------------------------------------------
    def counter(self, name: str) -> int:
        return self._counters.get(name, 0)

    def gauge(self, name: str, default: float = 0.0) -> float:
        return self._gauges.get(name, default)

    def histogram(self, name: str) -> Histogram | None:
        return self._hists.get(name)

    def snapshot(self) -> dict:
        return {
            "counters": {k: self._counters[k]
                         for k in sorted(self._counters)},
            "gauges": {k: self._gauges[k] for k in sorted(self._gauges)},
            "histograms": {k: self._hists[k].to_dict()
                           for k in sorted(self._hists)},
        }

    def merge_snapshot(self, snap: dict) -> None:
        """Fold one shard's snapshot into this registry: counters and
        histograms add; gauges last-write-wins (they are point-in-time
        readings, not accumulators)."""
        for k, v in snap.get("counters", {}).items():
            self.inc(k, v)
        for k, v in snap.get("gauges", {}).items():
            self.set_gauge(k, v)
        for k, d in snap.get("histograms", {}).items():
            incoming = Histogram.from_dict(d)
            mine = self._hists.get(k)
            self._hists[k] = (incoming if mine is None
                              else mine.merge(incoming))

    def reset(self) -> None:
        self._counters.clear()
        self._gauges.clear()
        self._hists.clear()


def merge_snapshots(snaps: Iterable[dict]) -> dict:
    """Merge per-shard registry snapshots (e.g. one JSON per subprocess
    of the sharded backend) into one global snapshot."""
    reg = MetricRegistry()
    for s in snaps:
        reg.merge_snapshot(s)
    return reg.snapshot()


_REGISTRY = MetricRegistry()


def get_registry() -> MetricRegistry:
    return _REGISTRY


def set_registry(reg: MetricRegistry) -> MetricRegistry:
    global _REGISTRY
    prev, _REGISTRY = _REGISTRY, reg
    return prev


# Module-level conveniences on the default registry, gated on enabled().
def inc(name: str, v: int = 1) -> None:
    if _ENABLED:
        _REGISTRY.inc(name, v)


def observe(name: str, value: float,
            edges: Sequence[float] = LATENCY_EDGES_US) -> None:
    if _ENABLED:
        _REGISTRY.observe(name, value, edges)


def set_gauge(name: str, v: float) -> None:
    if _ENABLED:
        _REGISTRY.set_gauge(name, v)


def counter_value(name: str) -> int:
    return _REGISTRY.counter(name)


class counting:
    """Delta of a counter over a ``with`` block.

    The default counter, ``routing.dispatches``, increments once per
    ``routing.dispatch`` call, which in the eager port is once per
    executed round: tests assert one-round properties with it.  The
    reference's ``count_traced_rounds`` (one ``jax.make_jaxpr`` trace)
    has no counterpart here, because eager torch has no trace to count.
    Counts only while recording is on."""

    def __init__(self, name: str = "routing.dispatches"):
        self.name = name
        self.delta = 0

    def __enter__(self) -> "counting":
        self._start = _REGISTRY.counter(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        self.delta = _REGISTRY.counter(self.name) - self._start
        return False


def merge_wire_stats(*stats: dict) -> dict:
    """Combine per-round wire accounting: ``wire_words`` add, ``fill_frac``
    is weighted by each round's wire words (a round that moved twice the
    words contributes twice the padding evidence).  Tensors in, tensors
    out; no registry access.  With one argument the two lanes pass
    through untouched."""
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


def save_snapshot(path: str, reg: MetricRegistry | None = None) -> None:
    """Write a registry snapshot as JSON (for cross-process merge)."""
    with open(path, "w") as f:
        json.dump((reg or _REGISTRY).snapshot(), f, indent=1, sort_keys=True)
