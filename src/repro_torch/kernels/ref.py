"""Plain PyTorch versions of the port's kernels.

Each function here computes exactly what its CUDA kernel computes, on
int32 bit-views of the words (``local_attention``: the same float32
function, summed in another order).  The CPU path runs them (``kernels/ops.py``
picks them for CPU tensors only), the tests hold them against the JAX
package's Pallas kernels, and ``chip_smoke.py`` holds each kernel against
them on the card.
"""
from __future__ import annotations

import math

import torch

from ..core import neighbors
from ..core.hashing import (
    CHECKSUM_SEED,
    SEED_LO,
    base_bucket,
    checksum32,
    hash64 as _hash64,
    murmur32_words,
)
from ..core.layout import INVALID, OCCUPIED


def route_pack(mat: torch.Tensor, inv: torch.Tensor,
               fill_row: torch.Tensor) -> torch.Tensor:
    """(n, L) item lanes -> (rows, L) send buffer: row i is
    ``mat[inv[i]]``, or the fill row where ``inv[i] == -1`` (every row
    when ``mat`` has none)."""
    if mat.shape[0] == 0:
        return fill_row[None, :].expand(inv.shape[0], -1).clone()
    picked = mat[inv.clamp(min=0).long()]
    return torch.where((inv >= 0)[:, None], picked, fill_row[None, :])


def route_unpack(buf: torch.Tensor, slot: torch.Tensor, kept: torch.Tensor,
                 fill_row: torch.Tensor) -> torch.Tensor:
    """(rows, L) reply buffer -> (n, L) item order: item i gets
    ``buf[slot[i]]``, or the fill row where ``kept[i] == 0``."""
    return torch.where((kept != 0)[:, None], buf[slot.long()],
                       fill_row[None, :])


def hash64(keys: torch.Tensor) -> torch.Tensor:
    """(N, KW) int32 -> (N, 2) int32 ``[hi, lo]``."""
    hi, lo = _hash64(keys)
    return torch.stack([hi, lo], dim=-1)


# (N, KW) x (N, VW) int32 -> (N,) int32 checksum over key || value
checksum = checksum32
# elementwise round to ``sig_digits`` significant digits (float32)
round_sig = neighbors.round_significant


def stencil_keys(x: torch.Tensor, sig_digits: int, key_words: int,
                 radius: int = 1, coarse_tier: bool = True,
                 n_buckets: int = 1024, n_probe: int = 6):
    """(n, D) queries -> ``(keys (n, M, KW), base (n, M))`` int32: the
    keys of ``core/neighbors.stencil_keys`` and each key's window base
    (``base_bucket`` of the hash64 lo lane)."""
    keys, _points = neighbors.stencil_keys(x, sig_digits, key_words,
                                           radius, coarse_tier)
    n, m, kw = keys.shape
    lo = murmur32_words(keys.reshape(n * m, kw), SEED_LO)
    return keys, base_bucket(lo, n_buckets, n_probe).reshape(n, m)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 where none)."""
    return torch.argmax(mask.to(torch.int32), dim=-1).to(torch.int32)


def _window(slab_keys: torch.Tensor, slab_meta: torch.Tensor,
            qkeys: torch.Tensor, base: torch.Tensor, n_probe: int):
    """Each query's candidate indices ``base .. base + n_probe - 1``
    (clamped into the slab) with their occupied, INVALID and key-equal
    masks, all (C, P)."""
    nb = slab_meta.shape[0]
    off = torch.arange(n_probe, dtype=torch.int64, device=base.device)
    idx = (base.long()[:, None] + off[None, :]).clamp(0, nb - 1)
    meta = slab_meta[idx]
    occupied = (meta & OCCUPIED) != 0
    invalid = (meta & INVALID) != 0
    keys_eq = (slab_keys[idx] == qkeys[:, None, :]).all(dim=-1)
    return idx, occupied, invalid, keys_eq


def _read_lane(slab_vals, slab_csum, qkeys, idx, occupied, invalid, keys_eq,
               validate_checksum: bool):
    """The engine's read: the first occupied, non-INVALID, key-equal
    candidate is selected (``rsel``, 0 where none); with
    ``validate_checksum`` only it is checksum-validated, with no
    fall-through to a later candidate.  ``found`` is 1 (hit), -1
    (selected but its checksum failed; never without validation) or 0
    (no candidate); ``vals`` is the selected value where ``found == 1``,
    else zeros."""
    rmatch = keys_eq & occupied & ~invalid
    has = rmatch.any(dim=-1)
    rsel = _first_true(rmatch)
    ridx = idx.gather(1, rsel.long()[:, None])[:, 0]
    val = slab_vals[ridx]
    if validate_checksum:
        ok = murmur32_words(torch.cat([qkeys, val], dim=-1),
                            CHECKSUM_SEED) == slab_csum[ridx]
        found = torch.where(has, torch.where(ok, 1, -1), 0)
    else:
        found = has
    found = found.to(torch.int32)
    val = torch.where((found == 1)[:, None], val, torch.zeros_like(val))
    return val, found, rsel


def probe(slab_keys: torch.Tensor, slab_vals: torch.Tensor,
          slab_meta: torch.Tensor, slab_csum: torch.Tensor,
          qkeys: torch.Tensor, base: torch.Tensor, n_probe: int,
          validate_checksum: bool = True):
    """The read probe over each query's window ``base .. base + n_probe -
    1`` (indices clamped into the slab), with the read semantics of
    :func:`_read_lane`.  Returns ``(vals (C, VW), found (C,), rsel (C,))``,
    all int32."""
    idx, occupied, invalid, keys_eq = _window(slab_keys, slab_meta, qkeys,
                                              base, n_probe)
    return _read_lane(slab_vals, slab_csum, qkeys, idx, occupied, invalid,
                      keys_eq, validate_checksum)


def shard_apply(slab_keys: torch.Tensor, slab_vals: torch.Tensor,
                slab_meta: torch.Tensor, slab_csum: torch.Tensor,
                qkeys: torch.Tensor, base: torch.Tensor, n_probe: int):
    """One pass over each query's window (as :func:`probe`):

    - read lane: :func:`probe` with checksum validation;
    - write lane (paper §3.1): same key (INVALID included) -> W_UPDATE at
      the first match; else the first empty or INVALID bucket -> W_INSERT;
      else the last candidate -> W_EVICT.

    Returns ``(vals (C, VW), found (C,), rsel (C,), wsel (C,), wkind (C,))``,
    all int32."""
    from ..core.op_engine import W_EVICT, W_INSERT, W_UPDATE

    idx, occupied, invalid, keys_eq = _window(slab_keys, slab_meta, qkeys,
                                              base, n_probe)
    val, found, rsel = _read_lane(slab_vals, slab_csum, qkeys, idx, occupied,
                                  invalid, keys_eq, True)
    wmatch = keys_eq & occupied
    writable = ~occupied | invalid
    has_match = wmatch.any(dim=-1)
    has_empty = writable.any(dim=-1)
    wsel = torch.where(
        has_match, _first_true(wmatch),
        torch.where(has_empty, _first_true(writable), n_probe - 1),
    ).to(torch.int32)
    wkind = torch.where(
        has_match, W_UPDATE, torch.where(has_empty, W_INSERT, W_EVICT),
    ).to(torch.int32)
    return val, found, rsel, wsel, wkind


def l1_probe(l1_keys: torch.Tensor, l1_vals: torch.Tensor,
             flags: torch.Tensor, qkeys: torch.Tensor,
             set_idx: torch.Tensor):
    """The L1 front end: for each query, the first way of its set
    ``set_idx`` that is coherent (``flags`` nonzero, (sets, ways)) and
    key-equal.  Returns ``(hit (n,) bool, vals (n, VW) int32)``, zeros
    where nothing hit."""
    s = set_idx.long()
    ok = ((l1_keys[s] == qkeys[:, None, :]).all(dim=-1)
          & (flags[s] != 0))                                  # (n, ways)
    hit = ok.any(dim=-1)
    val = l1_vals[s, _first_true(ok).long()]
    return hit, torch.where(hit[:, None], val, torch.zeros_like(val))


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int) -> torch.Tensor:
    """Causal sliding-window attention: q (B, S, H, D), k/v (B, S, Hk, D)
    -> (B, S, H, D) in q's type.  Query row i of head h attends over keys
    j of KV head ``h // (H // Hk)`` with ``j <= i`` and ``i - j < window``:
    the ``ref_local_attention`` formula (float32 scores, softmax and
    product) on K/V repeated per query group."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    kf = k.to(torch.float32).repeat_interleave(g, dim=2)
    vf = v.to(torch.float32).repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kf) / math.sqrt(d)
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    valid = ((qp - kp) < window) & (kp <= qp)
    scores = scores.masked_fill(~valid, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)
