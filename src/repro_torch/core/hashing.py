"""64-bit key hashing in 2x 32-bit lanes (PyTorch port of ``repro.core.hashing``).

The 64-bit key hash is a (hi, lo) pair of independently seeded murmur3
mixes.  ``hi`` picks the owner shard (``hash % S``, or the successor
vnode on a consistent-hash ring: :func:`ring_owner`), ``lo`` the start of
the contiguous ``n_probe`` candidate window.

Words are int32 bit-views.  The arithmetic widens to int64 holding the
unsigned value and masks every step back to 32 bits; products are split
so no int64 product overflows.  On the card the engine hashes and
checksums through the ``hash64`` and ``checksum`` kernels
(``kernels/hash_kernel.py``, ``kernels/checksum_kernel.py``); these
functions are their plain versions.
"""
from __future__ import annotations

import torch

from .layout import MASK32, to_i32, u32

# murmur3 constants (same as the reference)
_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_FMIX1 = 0x85EBCA6B
_FMIX2 = 0xC2B2AE35

SEED_HI = 0x9E3779B9
SEED_LO = 0x85EBCA77
CHECKSUM_SEED = 0xB5297A4D


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32), without an int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul(h, _FMIX1)
    h = h ^ (h >> 13)
    h = _mul(h, _FMIX2)
    return h ^ (h >> 16)


def murmur32_words(words: torch.Tensor, seed: int) -> torch.Tensor:
    """murmur3-style hash over the trailing word axis:
    (..., W) int32 -> (...,) int32 bit-view."""
    w = words.shape[-1]
    x = u32(words)
    h = torch.full(words.shape[:-1], seed & MASK32, dtype=torch.int64,
                   device=words.device)
    for i in range(w):
        k = _mul(x[..., i], _C1)
        k = _rotl32(k, 15)
        k = _mul(k, _C2)
        h = _rotl32(h ^ k, 13)
        h = (h * 5 + 0xE6546B64) & MASK32
    h = h ^ (w * 4)  # length in bytes
    return to_i32(_fmix32(h))


def hash64(key_words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) int32 pair forming the 64-bit key hash."""
    return (murmur32_words(key_words, SEED_HI),
            murmur32_words(key_words, SEED_LO))


def owner_shard(h_hi: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Paper: target_rank = hash % nprocs, on the unsigned value."""
    return (u32(h_hi) % n_shards).to(torch.int32)


def ring_owner(h_hi: torch.Tensor, positions: torch.Tensor,
               owners: torch.Tensor, n_live: int) -> torch.Tensor:
    """Consistent-hash ring lookup: the successor virtual node owns the
    key (``core/membership.py``).  ``positions`` is the ring's sorted
    (n_slots,) int64 vnode positions (dead slots 0xFFFFFFFF at the
    tail), ``owners`` the (n_slots,) int32 shard of each, ``n_live`` the
    live prefix; a hash past the last live vnode wraps to slot 0."""
    idx = torch.searchsorted(positions, u32(h_hi), side="left")
    idx = torch.where(idx >= n_live, 0, idx)
    return owners[idx].to(torch.int32)


def base_bucket(h_lo: torch.Tensor, n_buckets: int, n_probe: int
                ) -> torch.Tensor:
    """Start of the contiguous probe window, in [0, B - n_probe]."""
    span = max(n_buckets - n_probe + 1, 1)
    return (u32(h_lo) % span).to(torch.int32)


def probe_indices(base: torch.Tensor, n_probe: int) -> torch.Tensor:
    """(..., n_probe) candidate bucket indices (contiguous window)."""
    return base[..., None] + torch.arange(n_probe, dtype=torch.int32,
                                          device=base.device)


def checksum32(key_words: torch.Tensor, val_words: torch.Tensor
               ) -> torch.Tensor:
    """Lock-free bucket checksum over key||value (paper §4.2)."""
    return murmur32_words(torch.cat([key_words, val_words], dim=-1),
                          CHECKSUM_SEED)
