"""Skew diagnostics — who is hot, and how hot (PyTorch port of
``repro.obs.skew``; DESIGN.md §11).

Three views of load imbalance, host-side numpy over arrays the substrate
already produces (the table and cache views reduce on the device and
read one vector back):

- **wire skew** — :func:`imbalance` over a round's per-destination bin
  counts (the ``bin_counts`` stat lane every wrapper now returns): the
  max/mean ratio is exactly the capacity-padding overhead factor of the
  fused all_to_all (the round sizes every bin to the max), p99/p50 shows the
  tail, and ``hot_frac`` is the hottest shard's share of total traffic.
- **table skew** — :func:`bucket_occupancy` over a ``DHTState``: live
  buckets per shard (a rank's state of the multi-rank backend holds
  one), i.e. where the *stored* data sits.
- **L1 skew** — :func:`l1_set_occupancy` over an ``L1State``: live ways
  per cache set, i.e. whether a hot key-set is thrashing a few sets.

``repro_torch.obs.report --skew`` renders all three; the per-round
timeline gains an ``imb`` column from the same lanes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SkewStats", "imbalance", "bucket_occupancy", "l1_set_occupancy",
           "zipf_keys"]


@dataclasses.dataclass(frozen=True)
class SkewStats:
    """Imbalance summary of one non-negative load vector."""

    n: int                 # vector length (shards / sets / destinations)
    total: float
    mean: float
    max: float
    max_over_mean: float   # 1.0 = perfectly balanced
    p99_over_p50: float    # tail ratio (1.0 when the median carries the tail)
    hot_frac: float        # hottest entry's share of the total
    nonzero_frac: float    # fraction of entries with any load

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def imbalance(loads) -> SkewStats:
    """Summarize a per-destination (or per-shard / per-set) load vector.

    Degenerate inputs are well-defined: an empty or all-zero vector
    reports ratios of 1.0 (nothing is imbalanced about no traffic).
    """
    a = np.asarray(loads, dtype=np.float64).reshape(-1)
    n = int(a.size)
    total = float(a.sum()) if n else 0.0
    if n == 0 or total <= 0.0:
        return SkewStats(n=n, total=total, mean=0.0, max=0.0,
                         max_over_mean=1.0, p99_over_p50=1.0,
                         hot_frac=0.0, nonzero_frac=0.0)
    mean = total / n
    amax = float(a.max())
    p50 = float(np.percentile(a, 50))
    p99 = float(np.percentile(a, 99))
    return SkewStats(
        n=n,
        total=total,
        mean=mean,
        max=amax,
        max_over_mean=amax / mean,
        p99_over_p50=(p99 / p50) if p50 > 0.0 else float(a.max() > 0),
        hot_frac=amax / total,
        nonzero_frac=float((a > 0).mean()),
    )


def bucket_occupancy(state) -> SkewStats:
    """Live-bucket count per shard of a ``DHTState`` — where the stored
    entries sit.  Uses the table's one liveness definition
    (``layout.live_mask``), counted on the table's device and read back
    once."""
    from ..core.layout import live_mask

    live = live_mask(state.meta)
    # (S, B) -> per-shard live counts; a flat (B,) slab is one shard
    if live.dim() == 1:
        live = live[None]
    return imbalance(live.sum(dim=-1).cpu().numpy())


def l1_set_occupancy(l1) -> SkewStats:
    """Live-way count per cache set of an ``L1State`` — a hot key-set
    shows up as a few full sets while the rest stay empty."""
    # (sets, ways) bool, counted on the cache's device, read back once
    return imbalance(l1.live.sum(dim=-1).cpu().numpy())


def zipf_keys(rng: np.random.Generator, n: int, key_words: int,
              universe: int = 1 << 16, alpha: float = 1.1) -> np.ndarray:
    """(n, key_words) uint32 keys drawn Zipf(alpha) from a bounded key
    universe — the skewed-op-mix generator the cost-model sweep and the
    skew tests share.  ``alpha=0`` degenerates to uniform."""
    if alpha <= 0.0:
        idx = rng.integers(0, universe, n)
    else:
        ranks = np.arange(1, universe + 1, dtype=np.float64)
        p = ranks ** (-alpha)
        p /= p.sum()
        idx = rng.choice(universe, size=n, p=p)
    # expand each universe index to a deterministic multi-word key
    out = np.empty((n, key_words), np.uint32)
    x = idx.astype(np.uint64)
    for w in range(key_words):
        x = (x * np.uint64(6364136223846793005) + np.uint64(1442695040888963407))
        out[:, w] = (x >> np.uint64(16)).astype(np.uint32)
    return out
