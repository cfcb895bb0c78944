"""DHT read/write wrappers over the one-round engine (PyTorch port of the
``dht_read``/``dht_write``/``dht_read_many`` part of ``repro.core.dht``).

Each call is one engine round (``core/op_engine.dht_execute``) on the
single-device virtual-shard backend.  The table is updated in place.
The dual-epoch and issue/commit forms of the multi-key read belong to
later slices and raise.
"""
from __future__ import annotations

import torch

from . import routing
from .layout import DHTState
from .op_engine import (
    W_DROPPED,
    W_EVICT,
    W_INSERT,
    W_UPDATE,
    dht_execute,
    read_ops,
    write_ops,
)


def _wire_skew_stats(es: dict) -> dict:
    """The wire-accounting and skew lanes every wrapper re-exports."""
    return {k: es[k] for k in (
        "epoch", "wire_words", "fill_frac", "bin_counts",
        "bin_max_load", "bin_imbalance", "hot_frac")}


def _read_stats(valid, found, es) -> dict:
    return {
        "hits": found.sum().to(torch.int32),
        "misses": (valid & ~found).sum().to(torch.int32),
        "mismatches": es["mismatches"],
        "dropped": es["dropped"],
        "lock_tokens": es["lock_tokens"],
        "fallback_reads": es["fallback_reads"],
        **_wire_skew_stats(es),
    }


def _write_stats(code, es) -> dict:
    return {
        "inserted": (code == W_INSERT).sum().to(torch.int32),
        "updated": (code == W_UPDATE).sum().to(torch.int32),
        "evicted": (code == W_EVICT).sum().to(torch.int32),
        "dropped": es["dropped"],
        "rounds": es["rounds"],
        "lock_tokens": es["lock_tokens"],
        **_wire_skew_stats(es),
        "code": code,
    }


def _ones(keys: torch.Tensor) -> torch.Tensor:
    return torch.ones(keys.shape[0], dtype=torch.bool, device=keys.device)


def dht_write(state: DHTState, keys: torch.Tensor, vals: torch.Tensor,
              valid: torch.Tensor | None = None, *, max_retries: int = 0
              ) -> tuple[DHTState, dict]:
    """DHT_write: store/update a batch of key-value pairs.

    ``max_retries > 0`` re-issues rows the router dropped on a capacity
    overflow (``code == W_DROPPED``) for up to that many extra rounds;
    the default 0 is the single-round write."""
    if valid is None:
        valid = _ones(keys)
    state, _, _, _, code, es = dht_execute(
        state, write_ops(keys, vals, valid), kinds=("write",))
    total = _write_stats(code, es)
    for _ in range(max_retries):
        retry = valid & (total["code"] == W_DROPPED)
        if not bool(retry.any()):
            break
        state, _, _, _, code, es = dht_execute(
            state, write_ops(keys, vals, retry), kinds=("write",))
        stats = _write_stats(code, es)
        for lane in ("inserted", "updated", "evicted", "lock_tokens",
                     "wire_words", "rounds"):
            total[lane] = total[lane] + stats[lane]
        # a retried row's fresh outcome overrides its drop code
        total["code"] = torch.where(retry, stats["code"], total["code"])
        total["dropped"] = (valid & (total["code"] == W_DROPPED)).sum().to(
            torch.int32)
        valid = retry
    return state, total


def dht_read(state: DHTState, keys: torch.Tensor,
             valid: torch.Tensor | None = None
             ) -> tuple[DHTState, torch.Tensor, torch.Tensor, dict]:
    """DHT_read: fetch a batch of values.  Returns ``(state', vals,
    found, stats)``; ``state'`` changes only where a checksum-failed
    bucket is flagged INVALID."""
    if valid is None:
        valid = _ones(keys)
    state, _, vals, found, _code, es = dht_execute(
        state, read_ops(keys, valid), kinds=("read",))
    return state, vals, found, _read_stats(valid, found, es)


def dht_read_many(state: DHTState, keys: torch.Tensor,
                  valid: torch.Tensor | None = None, *, axis_name=None,
                  l1_meta: bool = False
                  ) -> tuple[DHTState, torch.Tensor, torch.Tensor, dict]:
    """Batched multi-key read: ``keys`` (n, m, KW), e.g. the stencil
    neighbourhood of n queries, with an optional (n, m) ``valid`` mask;
    all n*m probes share ONE routing round.  Returns ``(state', vals
    (n, m, VW), found (n, m), stats)``."""
    if axis_name is not None:
        raise routing.not_ported("the multi-rank backend (axis_name)", "7")
    if l1_meta:
        raise routing.not_ported("dht_read_many(l1_meta=True)", "9")
    n, m = keys.shape[0], keys.shape[1]
    flat, vflat = routing.flatten_fanout(keys, valid)
    state, val, found, stats = dht_read(state, flat, vflat)
    return (state, routing.unflatten_fanout(val, n, m),
            routing.unflatten_fanout(found, n, m), stats)


def dht_read_many_dual(state, prev, keys, valid=None, *, axis_name=None):
    """Dual-epoch multi-key read (elastic membership, a later slice)."""
    raise routing.not_ported("dht_read_many_dual", "11")


def dht_read_many_async(state, keys, valid=None, *, axis_name=None,
                        l1_meta=False, pending=None):
    """Issue half of the multi-key read (issue/commit, a later slice)."""
    raise routing.not_ported("dht_read_many_async", "10")


def dht_read_many_commit(rnd):
    """Commit half of the multi-key read (issue/commit, a later slice)."""
    raise routing.not_ported("dht_read_many_commit", "10")
