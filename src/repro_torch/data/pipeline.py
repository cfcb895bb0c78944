"""Deterministic sharded synthetic data pipeline: the port's own copy of
``repro/data/pipeline.py`` (plain numpy, the same arrays).

An index space of documents is deterministically partitioned over data
shards by (step, shard), so any shard can recompute any batch without
coordination: restart or straggler reassignment is pure arithmetic, and
an elastic resize re-partitions the same index space with no data lost
or duplicated.

The documents are synthetic token streams from a counter-based RNG (a
Zipf unigram mix with a per-document offset, so a loss can decrease); a
real deployment swaps ``_materialize`` for a tokenized corpus reader and
keeps everything above it.  The Zipf draws are numpy's: the arrays equal
the reference's on the same numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    shard: int = 0
    n_shards: int = 1

    def __post_init__(self):
        if not 0 <= self.shard < self.n_shards:
            raise ValueError(f"shard {self.shard} out of range for "
                             f"{self.n_shards} shards")


def _doc_rng(cfg: DataConfig, doc_id: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, int(doc_id)]))


def _materialize(cfg: DataConfig, doc_id: int) -> np.ndarray:
    """One document of seq_len + 1 tokens (inputs and shifted labels)."""
    rng = _doc_rng(cfg, doc_id)
    toks = rng.zipf(cfg.zipf_a, size=cfg.seq_len + 1) % cfg.vocab_size
    offset = rng.integers(0, cfg.vocab_size)
    return ((toks + offset) % cfg.vocab_size).astype(np.int32)


def batch_doc_ids(cfg: DataConfig, step: int, shard: ShardInfo) -> np.ndarray:
    """Global batch of step s = documents [s*B, (s+1)*B), split
    contiguously over the shards."""
    per = cfg.global_batch // shard.n_shards
    start = step * cfg.global_batch + shard.shard * per
    return np.arange(start, start + per, dtype=np.int64)


def get_batch(cfg: DataConfig, step: int,
              shard: ShardInfo = ShardInfo()) -> dict[str, np.ndarray]:
    """``{"tokens": (B_local, S), "labels": (B_local, S)}`` int32 for
    this shard."""
    ids = batch_doc_ids(cfg, step, shard)
    docs = np.stack([_materialize(cfg, int(i)) for i in ids])
    return {"tokens": docs[:, :-1], "labels": docs[:, 1:].copy()}


def reassign_straggler(cfg: DataConfig, step: int, dead_shard: int,
                       shard: ShardInfo) -> np.ndarray:
    """The survivors split the dead shard's documents deterministically:
    no coordinator, pure arithmetic."""
    dead = batch_doc_ids(cfg, step, ShardInfo(dead_shard, shard.n_shards))
    survivors = shard.n_shards - 1
    my_rank = shard.shard if shard.shard < dead_shard else shard.shard - 1
    return dead[my_rank::survivors]
