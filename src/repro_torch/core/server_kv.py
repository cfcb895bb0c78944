"""Server-based key-value baseline (PyTorch port of
``repro.core.server_kv``; the paper's DAOS stand-in, §3.2 / Fig. 3).

Every operation is an RPC to ONE server, whose service capacity, not the
client count, bounds throughput.  The model: all requests go to a single
shard holding every bucket (the "server node"), which drains its queue
``server_width`` ops a round (its core count).  The distributed table of
``core/dht.py`` spreads the same traffic over every shard in one round
instead.
"""
from __future__ import annotations

import torch

from ..kernels import ops as kops
from .hashing import base_bucket
from .layout import DHTConfig, DHTState, dht_create
from .op_engine import _apply_writes, _probe_window


def server_create(cfg: DHTConfig, *, device: str | torch.device | None = None
                  ) -> DHTState:
    """One storage target owning all ``S * B`` buckets of ``cfg``, in
    coarse mode (the server serializes, so it is consistent by
    construction), on ``device`` (CUDA unless the caller asks for
    another)."""
    server_cfg = DHTConfig(
        key_words=cfg.key_words,
        val_words=cfg.val_words,
        n_shards=1,
        buckets_per_shard=cfg.n_shards * cfg.buckets_per_shard,
        n_probe=cfg.n_probe,
        mode="coarse",
        capacity=0,
        max_read_retries=cfg.max_read_retries,
    )
    return dht_create(server_cfg, device=device)


def _server_rounds(n_ops: int, server_width: int) -> int:
    return -(-n_ops // max(server_width, 1))


def _bases(state: DHTState, keys: torch.Tensor) -> torch.Tensor:
    cfg = state.cfg
    h = kops.hash64(keys.contiguous())
    return base_bucket(h[:, 1], cfg.buckets_per_shard, cfg.n_probe)


def server_write(state: DHTState, keys: torch.Tensor, vals: torch.Tensor,
                 server_width: int = 24) -> tuple[DHTState, dict]:
    """All clients RPC the server; it applies ``server_width`` ops a
    round, each round through the engine's write passes.  The table is
    updated in place.  Returns ``(state', {"rounds": int})``."""
    n = keys.shape[0]
    rounds = _server_rounds(n, server_width)
    base = _bases(state, keys)
    vals = vals.to(torch.int32)
    iota = torch.arange(n, device=keys.device)
    for r in range(rounds):
        mask = (iota >= r * server_width) & (iota < (r + 1) * server_width)
        _apply_writes(state, base, keys, vals, mask)
    return state, {"rounds": rounds}


def server_read(state: DHTState, keys: torch.Tensor, server_width: int = 24
                ) -> tuple[DHTState, torch.Tensor, torch.Tensor, dict]:
    """Read through the server: one probe pass over the batch (coarse
    mode reads without a checksum, so nothing is flagged), billed as
    ``ceil(n / server_width)`` rounds.  Returns ``(state, vals, found,
    {"rounds": int})``."""
    rounds = _server_rounds(keys.shape[0], server_width)
    found_tri, _sel, val = _probe_window(state, _bases(state, keys), keys)
    found = found_tri == 1
    return state, torch.where(found[:, None], val, 0), found, \
        {"rounds": rounds}


__all__ = ["server_create", "server_read", "server_write"]
