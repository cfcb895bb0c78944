"""DHT-backed preprocessing memoization: the port of
``repro/data/memo.py``, the paper's surrogate pattern applied to the
data pipeline.

A tokenizer stand-in (a deliberately expensive deterministic transform)
is cached in the shared table keyed by document id: across epochs, or
across workers re-reading a shard, the expensive pass is skipped as POET
skips its solver for chemistry inputs it has seen.

Keys and digests are the int32 bit-views of the reference's uint32 words
(the table's convention).  The transform's uint32 arithmetic runs on an
int64 copy masked to 32 bits after every step, so the product wraps and
the right shift is logical, as in the reference.
"""
from __future__ import annotations

import torch

from ..core import DHTConfig, DHTState, dht_create, dht_read, dht_write
from ..core.layout import MASK32, to_i32, u32

TRANSFORM_ROUNDS = 100
_MUL = 747796405
_ADD = 2891336453


def memo_config(n_shards: int = 1, buckets_per_shard: int = 1 << 14) -> DHTConfig:
    # key: the doc id (1 word used of 4); value: the 16-word digest
    return DHTConfig(key_words=4, val_words=16, n_shards=n_shards,
                     buckets_per_shard=buckets_per_shard)


def create(cfg: DHTConfig, device=None) -> DHTState:
    """The empty memo table, on the card unless ``device`` names another."""
    return dht_create(cfg, device=device)


def _expensive_transform(doc_ids: torch.Tensor) -> torch.Tensor:
    """(N,) ids -> (N, 16) int32 bit-views of the digest: word j of a doc
    starts at ``id * (j + 1)`` and goes through 100 rounds of
    ``v = v * 747796405 + 2891336453; v ^= v >> 13`` in uint32."""
    mult = torch.arange(1, 17, dtype=torch.int64, device=doc_ids.device)
    v = (u32(doc_ids)[:, None] * mult) & MASK32
    for _ in range(TRANSFORM_ROUNDS):
        v = (v * _MUL + _ADD) & MASK32
        v = v ^ (v >> 13)
    return to_i32(v)


def _keys_of(ids: torch.Tensor) -> torch.Tensor:
    k = torch.zeros((ids.shape[0], 4), dtype=torch.int32, device=ids.device)
    k[:, 0] = to_i32(u32(ids))
    return k


def lookup_or_process(state: DHTState, doc_ids: torch.Tensor, *,
                      axis_name=None):
    """Returns ``(state', digests (N, 16) int32 bit-views, hits)``: the
    stored digest where the table holds the doc, the transform's
    elsewhere, which one write round then stores (``hits`` a device
    scalar)."""
    doc_ids = torch.as_tensor(doc_ids, device=state.device)
    keys = _keys_of(doc_ids)
    state, vals, found, rstats = dht_read(state, keys, axis_name=axis_name)
    computed = _expensive_transform(doc_ids)
    out = torch.where(found[:, None], vals, computed)
    state, _ = dht_write(state, keys, computed, valid=~found,
                         axis_name=axis_name)
    return state, out, rstats["hits"]
