"""Per-device L1 hot-key cache, the locality tier's front end (PyTorch port
of ``repro.core.l1cache``).

Skewed traffic (POET grid cells re-querying near-identical chemistry, Zipf
keys) re-reads the same keys, so a small cache in front of the router
serves the hot part of the stream with a local probe instead of a routing
round.

Layout: a set-associative array of lines, one line = ``(key, val, csum,
gen)`` plus the coherence stamp ``(epoch, owner, wmark)``:

- ``set`` = ``fold32(hash_hi, hash_lo) % n_sets``, decorrelated from both
  the owner shard (``hash_hi``) and the probe window (``hash_lo``);
- ``way`` = a second slice of the same word: a key always claims the same
  way of its set, so inserts need no replacement state;
- ``csum`` is the key||value checksum at fill time, ``gen`` the serving
  bucket's write generation at the snapshot the value was read.

Coherence costs no extra round: a line is served only if its epoch is the
table's and its ``wmark`` stamp equals the current watermark of its owner
shard (``layout.shard_watermark``, which grows under every meta
transition the protocol makes).  A write to any bucket of a shard
therefore retires all of that shard's lines.

The cache lives in flat buffers with one trailing dump line, like the
table (``core/layout.py``): :func:`l1_insert` aims the items that must not
land at the dump line and updates the buffers in place.  Words are int32
bit-views of the reference's uint32 words.  The per-query probe is the
``l1_probe`` kernel on the card (``kernels/ops.py``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels import ops as kops
from ..obs import metrics as obs_metrics
from .hashing import murmur32_words
from .layout import resolve_device, u32

_FOLD_SEED = 0x94D049BB


@dataclasses.dataclass(frozen=True)
class L1Config:
    """Static cache geometry (same fields and defaults as the reference)."""

    n_sets: int = 256
    n_ways: int = 4
    key_words: int = 20
    val_words: int = 26

    def __post_init__(self):
        if self.n_sets < 1 or self.n_ways < 1:
            raise ValueError("need n_sets >= 1 and n_ways >= 1")

    @property
    def n_lines(self) -> int:
        return self.n_sets * self.n_ways

    @property
    def bytes(self) -> int:
        # key + val + csum + gen + wmark (u32) + owner + epoch (i32) + live
        return self.n_lines * (4 * (self.key_words + self.val_words + 5) + 1)


@dataclasses.dataclass(eq=False)
class L1State:
    """The cache: flat line buffers of ``n_lines`` rows plus the dump
    line, and ``shard_wmark``, the latest known watermark of every shard
    (refreshed from each cached round's reply piggyback).  ``l1.keys``
    & co. are (sets, ways, ...) views without the dump line."""

    cfg: L1Config
    flat_keys: torch.Tensor    # (lines + 1, KW) int32
    flat_vals: torch.Tensor    # (lines + 1, VW) int32
    flat_csum: torch.Tensor    # (lines + 1,) int32
    flat_gen: torch.Tensor     # (lines + 1,) int32 bucket generation stamp
    flat_owner: torch.Tensor   # (lines + 1,) int32 owner shard of the key
    flat_wmark: torch.Tensor   # (lines + 1,) int32 owner watermark stamp
    flat_epoch: torch.Tensor   # (lines + 1,) int32 membership epoch stamp
    flat_live: torch.Tensor    # (lines + 1,) bool
    shard_wmark: torch.Tensor  # (n_shards,) int32 latest known watermarks

    def _lines(self, flat: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        return flat[:-1].view((c.n_sets, c.n_ways) + tuple(flat.shape[1:]))

    keys = property(lambda self: self._lines(self.flat_keys))
    vals = property(lambda self: self._lines(self.flat_vals))
    csum = property(lambda self: self._lines(self.flat_csum))
    gen = property(lambda self: self._lines(self.flat_gen))
    owner = property(lambda self: self._lines(self.flat_owner))
    wmark = property(lambda self: self._lines(self.flat_wmark))
    epoch = property(lambda self: self._lines(self.flat_epoch))
    live = property(lambda self: self._lines(self.flat_live))


def l1_create(cfg: L1Config, n_shards: int, *,
              device: str | torch.device | None = None) -> L1State:
    """The empty cache on ``device`` (CUDA unless the caller asks for
    another)."""
    dev = resolve_device(device)
    obs_metrics.inc("l1.creates")
    rows = cfg.n_lines + 1
    z = dict(dtype=torch.int32, device=dev)
    return L1State(
        cfg=cfg,
        flat_keys=torch.zeros((rows, cfg.key_words), **z),
        flat_vals=torch.zeros((rows, cfg.val_words), **z),
        flat_csum=torch.zeros((rows,), **z),
        flat_gen=torch.zeros((rows,), **z),
        flat_owner=torch.full((rows,), -1, **z),
        flat_wmark=torch.zeros((rows,), **z),
        flat_epoch=torch.full((rows,), -1, **z),
        flat_live=torch.zeros((rows,), dtype=torch.bool, device=dev),
        shard_wmark=torch.zeros((n_shards,), **z),
    )


def l1_flush(l1: L1State) -> L1State:
    """Drop every line (in place; an epoch change does this implicitly
    through the stamp)."""
    obs_metrics.inc("l1.flushes")
    l1.flat_live.zero_()
    return l1


def with_shard_wmarks(l1: L1State, wmarks: torch.Tensor) -> L1State:
    """Refresh the known-watermark table from a round's reply piggyback
    (int32 bit-view words; the width follows the round's shard count)."""
    l1.shard_wmark = wmarks.to(torch.int32).reshape(-1)
    return l1


def fold32(h_hi: torch.Tensor, h_lo: torch.Tensor) -> torch.Tensor:
    """Mix the 64-bit key hash into one word decorrelated from both lanes
    (int32 bit-view); the L1 set index derives from it."""
    return murmur32_words(torch.stack([h_hi, h_lo], dim=-1), _FOLD_SEED)


def l1_slots(cfg: L1Config, h_hi: torch.Tensor, h_lo: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(set, way) a key maps to, int32, from the unsigned fold."""
    f = u32(fold32(h_hi, h_lo))
    set_idx = (f % cfg.n_sets).to(torch.int32)
    way_idx = ((f // cfg.n_sets) % cfg.n_ways).to(torch.int32)
    return set_idx, way_idx


def serve_flags(l1: L1State, known_wmark: torch.Tensor, epoch,
                alive: torch.Tensor | None = None) -> torch.Tensor:
    """(sets, ways) bool: which lines are coherent now: live, of the
    current membership epoch, and stamped with their owner's latest known
    watermark (``known_wmark``, (S,) int32 bit-view words).

    ``alive`` (the ring's per-shard liveness, a bool tensor on the L1's
    device) also fences lines whose serving shard has crashed: a failover
    flushes the dead shard's lines like an epoch change.  ``ring_crash``
    bumps the epoch already, which kills every line cached before the
    crash; the gate holds for a liveness flip that skipped the bump."""
    owner = l1.owner.clamp(0, known_wmark.shape[0] - 1).long()
    ok = (l1.live & (l1.epoch == int(epoch))
          & (l1.wmark == known_wmark[owner]))
    if alive is not None:
        ok = ok & alive[l1.owner.clamp(0, alive.shape[0] - 1).long()]
    return ok


def l1_probe(cfg: L1Config, l1: L1State, keys: torch.Tensor,
             set_idx: torch.Tensor, flags: torch.Tensor):
    """Pre-routing probe: ``(hit (n,) bool, vals (n, VW) int32)``, the
    first coherent key-equal way of each query's set (the ``l1_probe``
    kernel on the card)."""
    return kops.l1_probe(l1.keys, l1.vals, flags, keys.contiguous(),
                         set_idx)


def l1_insert(cfg: L1Config, l1: L1State, keys, vals, gen, owner, wmark,
              epoch, set_idx, way_idx, mask) -> L1State:
    """Fill lines for the masked items (residue reads that came back
    found) in one deterministic scatter: among batch items landing on one
    (set, way), the highest item index wins, the same rule as the slab
    write pass.  Updates ``l1`` in place and returns it."""
    n = keys.shape[0]
    dump = cfg.n_lines
    dev = keys.device
    line = (set_idx.long() * cfg.n_ways + way_idx.long())
    prio = torch.where(mask, torch.arange(n, dtype=torch.int32, device=dev),
                       -1)
    winner = torch.full((dump + 1,), -1, dtype=torch.int32, device=dev)
    winner.scatter_reduce_(0, torch.where(mask, line, dump), prio, "amax")
    wline = torch.where(mask & (winner[line] == prio), line, dump)
    l1.flat_keys[wline] = keys.to(torch.int32)
    l1.flat_vals[wline] = vals.to(torch.int32)
    l1.flat_csum[wline] = kops.checksum(keys, vals)
    l1.flat_gen[wline] = gen.to(torch.int32)
    l1.flat_owner[wline] = owner.to(torch.int32)
    l1.flat_wmark[wline] = wmark.to(torch.int32)
    l1.flat_epoch[wline] = int(epoch)
    l1.flat_live[wline] = True
    return l1


__all__ = [
    "L1Config", "L1State", "fold32", "l1_create", "l1_flush", "l1_insert",
    "l1_probe", "l1_slots", "serve_flags", "with_shard_wmarks",
]
