"""Surrogate-model cache on top of the DHT (PyTorch port of the exact-match
part of ``repro.core.surrogate``, paper §5.4).

POET's pattern: round the expensive simulation's inputs to ``sig_digits``
significant digits, pack the rounded vector into the DHT key, store the
exact output as the value.  A later query whose rounded inputs coincide
skips the simulation.
"""
from __future__ import annotations

import dataclasses

import torch

from . import dht as dht_ops
from .layout import (
    DHTConfig,
    DHTState,
    dht_create,
    pack_floats,
    unpack_floats,
)
from .neighbors import round_significant
from .op_engine import W_INSERT, dht_execute, migrate_ops


@dataclasses.dataclass(frozen=True)
class SurrogateConfig:
    n_inputs: int = 10        # POET: 9 species + time step
    n_outputs: int = 13       # POET: 13 result values
    sig_digits: int = 4       # key rounding (accuracy/hit-rate trade-off)
    dht: DHTConfig = dataclasses.field(default_factory=DHTConfig)

    def __post_init__(self):
        if self.dht.key_words < 2 * self.n_inputs:
            raise ValueError("key_words too small for n_inputs")
        if self.dht.val_words < 2 * self.n_outputs:
            raise ValueError("val_words too small for n_outputs")


def surrogate_create(cfg: SurrogateConfig, *,
                     device: str | torch.device | None = None) -> DHTState:
    """The empty cache on ``device`` (CUDA unless the caller asks for
    another).  Elastic placement is a later slice."""
    return dht_create(cfg.dht, device=device)


def make_keys(cfg: SurrogateConfig, inputs: torch.Tensor) -> torch.Tensor:
    """(n, n_inputs) float -> (n, KW) int32 rounded keys (80 B for POET)."""
    return pack_floats(round_significant(inputs, cfg.sig_digits),
                       cfg.dht.key_words)


def lookup(cfg: SurrogateConfig, state: DHTState, inputs: torch.Tensor):
    """Query the cache.  Returns ``(state', outputs, found, stats)``."""
    state, val_words, found, stats = dht_ops.dht_read(
        state, make_keys(cfg, inputs))
    return state, unpack_floats(val_words, cfg.n_outputs), found, stats


def store(cfg: SurrogateConfig, state: DHTState, inputs: torch.Tensor,
          outputs: torch.Tensor, valid=None):
    keys = make_keys(cfg, inputs)
    vals = pack_floats(outputs, cfg.dht.val_words)
    return dht_ops.dht_write(state, keys, vals, valid)


def lookup_or_compute(cfg: SurrogateConfig, state: DHTState,
                      inputs: torch.Tensor, compute_fn, *,
                      one_round: bool = False):
    """The surrogate pattern: hit -> reuse; miss -> compute and publish.

    ``compute_fn(inputs) -> outputs`` is the expensive simulation.

    Host form (default): a read round first; a full-hit batch returns
    without calling ``compute_fn``, otherwise the misses are computed
    and written back in a second round.

    ``one_round=True``: ``compute_fn`` runs on every row and the lookup
    and write-back ride ONE get-or-put round (``OP_MIGRATE``): present
    keys return their stored value, absent keys publish the computed
    one.  This is the form the reference takes under tracing."""
    if not one_round:
        state, cached, found, rstats = lookup(cfg, state, inputs)
        stats = {"hits": rstats["hits"], "misses": rstats["misses"],
                 "mismatches": rstats["mismatches"], "stored": 0}
        if bool(found.all()):
            return state, cached, found, stats
        computed = compute_fn(inputs)
        outputs = torch.where(found[:, None], cached, computed)
        state, wstats = store(cfg, state, inputs, computed, valid=~found)
        stats["stored"] = wstats["inserted"]
        return state, outputs, found, stats

    keys = make_keys(cfg, inputs)
    computed = compute_fn(inputs)
    vals = pack_floats(computed, cfg.dht.val_words)
    state, _, val_words, found, code, es = dht_execute(
        state, migrate_ops(keys, vals), kinds=("migrate",))
    cached = unpack_floats(val_words, cfg.n_outputs)
    outputs = torch.where(found[:, None], cached, computed)
    stats = {
        "hits": found.sum().to(torch.int32),
        "misses": (~found).sum().to(torch.int32),
        "mismatches": es["mismatches"],
        "stored": (code == W_INSERT).sum().to(torch.int32),
    }
    return state, outputs, found, stats
