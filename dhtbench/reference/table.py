"""Plain PyTorch model of the lock-free DHT's placement and slot policy,
for the benchmark's reference.  It imports nothing of the program and
takes nothing the program made: it hashes the keys itself, keeps its own
table of record ids, and decides every read and write by the rules the
paper states (§3, the lock-free window):

- a key's 64-bit hash is two murmur3 chains over its 32-bit words,
  seeded ``SEED_HI`` and ``SEED_LO``; the owner shard is ``hi mod S``,
  the first bucket of its window ``lo mod (B - P + 1)``; the window is
  the ``P`` buckets from there;
- a read finds the first bucket of the window that holds the key, and
  sees the table as it stood when its round began;
- a write of a key in its window updates that bucket; else it inserts
  into the first empty bucket; else it evicts the window's last bucket.
  Writers of one round that pick the same bucket are resolved by row:
  the last row wins; a row that lost to another key tries again, on the
  table the winners left, up to ``P`` passes; an evicting row does not.

The table holds, for each bucket, the id of the record in it (-1 empty)
and a source tag the caller decodes into the value it expects there.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
SEED_HI = 0x9E3779B9
SEED_LO = 0x85EBCA77

UPDATE, INSERT, EVICT = 2, 1, 3   # the program's result codes


def _mulmod(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64, with no
    product past 2^63."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def murmur3(words: torch.Tensor, seed: int) -> torch.Tensor:
    """MurmurHash3 (x86, 32-bit) over whole 32-bit words: (n, W) int32
    -> (n,) int64 in [0, 2^32)."""
    x = words.to(torch.int64) & MASK
    h = torch.full(words.shape[:1], seed, dtype=torch.int64,
                   device=words.device)
    for i in range(words.shape[1]):
        k = _rotl(_mulmod(x[:, i], 0xCC9E2D51), 15)
        k = _mulmod(k, 0x1B873593)
        h = _rotl(h ^ k, 13)
        h = (h * 5 + 0xE6546B64) & MASK
    h = h ^ (4 * words.shape[1])
    h = h ^ (h >> 16)
    h = _mulmod(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mulmod(h, 0xC2B2AE35)
    return h ^ (h >> 16)


class Table:
    """``S`` shards of ``B`` buckets, windows of ``P``."""

    def __init__(self, n_shards: int, buckets: int, n_probe: int, device):
        self.S, self.B, self.P = n_shards, buckets, n_probe
        self.rid = torch.full((n_shards * buckets,), -1, dtype=torch.int64,
                              device=device)
        self.src = torch.zeros(n_shards * buckets, dtype=torch.int64,
                               device=device)
        self._off = torch.arange(n_probe, dtype=torch.int64, device=device)
        # each pass's winner of a bucket; -1 again once the pass is done
        self._best = torch.full_like(self.rid, -1)

    def window_start(self, keys: torch.Tensor, chunk: int = 1 << 22
                     ) -> torch.Tensor:
        """(n, KW) int32 keys -> (n,) int64 index of each window's first
        bucket in the flat table."""
        out = []
        for lo in range(0, keys.shape[0], chunk):
            k = keys[lo:lo + chunk]
            hi, lo_h = murmur3(k, SEED_HI), murmur3(k, SEED_LO)
            out.append((hi % self.S) * self.B + lo_h % (self.B - self.P + 1))
        return torch.cat(out) if out else torch.zeros(
            0, dtype=torch.int64, device=self.rid.device)

    def _window(self, start: torch.Tensor) -> torch.Tensor:
        return start[:, None] + self._off[None, :]

    def find_rid(self, start: torch.Tensor, rid: torch.Tensor):
        """Reads of records by id: ``(found, slot)``."""
        idx = self._window(start)
        hit = self.rid[idx] == rid[:, None]
        slot = idx.gather(1, torch.argmax(hit.to(torch.int32), 1)[:, None])[:, 0]
        return hit.any(dim=1), slot

    def find_keys(self, start: torch.Tensor, keys: torch.Tensor,
                  stored_keys: torch.Tensor):
        """Reads by key words: ``(found, rid)``; ``stored_keys[r]`` are
        record ``r``'s key words."""
        idx = self._window(start)
        cand = self.rid[idx]
        eq = (stored_keys[cand.clamp(min=0)] == keys[:, None, :]).all(dim=-1)
        hit = eq & (cand >= 0)
        first = torch.argmax(hit.to(torch.int32), 1)[:, None]
        return hit.any(dim=1), cand.gather(1, first)[:, 0]

    def write(self, start: torch.Tensor, rid: torch.Tensor,
              src: torch.Tensor) -> torch.Tensor:
        """One round of writes, rows in order; returns each row's code."""
        n = rid.shape[0]
        code = torch.zeros(n, dtype=torch.int32, device=rid.device)
        active = torch.ones(n, dtype=torch.bool, device=rid.device)
        prio = torch.arange(n, dtype=torch.int64, device=rid.device)
        for _ in range(self.P):
            a = torch.nonzero(active)[:, 0]
            if a.numel() == 0:
                break
            st, r = start[a], rid[a]
            idx = self._window(st)
            cur = self.rid[idx]
            same, empty = cur == r[:, None], cur < 0
            has_same, has_empty = same.any(dim=1), empty.any(dim=1)
            pick = torch.where(
                has_same, torch.argmax(same.to(torch.int32), 1),
                torch.where(has_empty, torch.argmax(empty.to(torch.int32), 1),
                            self.P - 1))
            kind = torch.where(has_same, UPDATE,
                               torch.where(has_empty, INSERT, EVICT))
            slot = st + pick
            best = self._best
            best.scatter_reduce_(0, slot, prio[a], "amax")
            won = best[slot] == prio[a]
            best[slot] = -1
            self.rid[slot[won]] = r[won]
            self.src[slot[won]] = src[a][won]
            code[a] = kind.to(torch.int32)
            active[a] = (self.rid[slot] != r) & (kind != EVICT)
        return code
