"""Distributed prefix cache: DHT pointers into a paged KV pool (the port
of ``repro/serving/prefix_cache.py``).

The paper's surrogate pattern applied to LM serving: the expensive
computation is prompt prefill; the DHT maps *chained block hashes* of
prompt token blocks to (page_id, generation) pointers into a paged KV
pool on the device.  A repeated prefix skips its prefill as POET skips
its solver for a chemistry input it has seen.

Pointers are validated optimistically: a page may have been recycled
after its pointer was written, so every hit re-checks the pool's
generation counter (a stale pointer is a miss, never a wrong page).  A
publish of more pages than the pool holds raises before it allocates
(F12 in ROADMAP.md: the reference recycles pages handed out earlier in
the same call, so two blocks would point at one page).

The DHT is the port's ``core`` table on the pool's device; its keys and
values go in as the int32 bit-views of the uint32 words.  The pool's
pages live on the device, its generation counters, FIFO and free list on
the host, as in the reference.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from ..core import DHTConfig, dht_create, dht_read, dht_write
from ..core.async_sim import hash64_np
from ..core.layout import resolve_device

KEY_WORDS = 4   # (chain_hi, chain_lo, block_index, salt)
VAL_WORDS = 4   # (page_id, generation, chain_hi echo, 0)


def dht_config(n_shards: int = 1, buckets_per_shard: int = 1 << 12) -> DHTConfig:
    return DHTConfig(key_words=KEY_WORDS, val_words=VAL_WORDS,
                     n_shards=n_shards, buckets_per_shard=buckets_per_shard)


def chain_block_keys(tokens: np.ndarray, page_size: int) -> np.ndarray:
    """tokens: (S,) ints, S % page_size == 0 -> (n_blocks, KEY_WORDS) keys.
    key_i = H(key_{i-1} || block_i): a hit on block i implies the whole
    prefix matches."""
    s = len(tokens)
    if s % page_size:
        raise ValueError(f"{s} tokens are not a multiple of the page size "
                         f"{page_size}")
    n = s // page_size
    keys = np.zeros((n, KEY_WORDS), np.uint32)
    prev = np.zeros(2, np.uint32)
    for i in range(n):
        block = np.asarray(tokens[i * page_size:(i + 1) * page_size], np.uint32)
        words = np.concatenate([prev, block]).astype(np.uint32)[None]
        hi, lo = hash64_np(words)
        prev = np.array([hi[0], lo[0]], np.uint32)
        keys[i] = (prev[0], prev[1], np.uint32(i), np.uint32(0x9E37))
    return keys


def _words(a: np.ndarray, device) -> torch.Tensor:
    """uint32 words as their int32 bit-view on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32)).to(device)


@dataclasses.dataclass
class PagePool:
    """Paged KV storage on the device: one page = ``page_size`` tokens of
    every layer's K and V."""

    k: torch.Tensor          # (n_pages, L, page_size, Hk, D)
    v: torch.Tensor
    gen: np.ndarray          # (n_pages,) host-side generation counters
    fifo: deque              # allocation order (recycled oldest-first)
    free: list
    page_size: int

    @classmethod
    def create(cls, n_pages, n_layers, page_size, n_kv_heads, head_dim,
               dtype=torch.bfloat16, *, device=None):
        shape = (n_pages, n_layers, page_size, n_kv_heads, head_dim)
        dev = resolve_device(device)
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=dev),
            v=torch.zeros(shape, dtype=dtype, device=dev),
            gen=np.zeros((n_pages,), np.int32),
            fifo=deque(), free=list(range(n_pages)), page_size=page_size,
        )

    def alloc(self, n: int) -> np.ndarray:
        ids = []
        for _ in range(n):
            if self.free:
                pid = self.free.pop()
            else:
                pid = self.fifo.popleft()       # recycle oldest
                self.gen[pid] += 1              # invalidates stale pointers
            self.fifo.append(pid)
            ids.append(pid)
        return np.asarray(ids, np.int32)

    def _index(self, ids: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(ids, np.int64)).to(self.k.device)

    def write(self, ids: np.ndarray, k_pages: torch.Tensor,
              v_pages: torch.Tensor) -> None:
        """k_pages: (n, L, page_size, Hk, D), written in place."""
        idx = self._index(ids)
        self.k[idx] = k_pages.to(self.k.dtype)
        self.v[idx] = v_pages.to(self.v.dtype)

    def read(self, ids: np.ndarray):
        idx = self._index(ids)
        return self.k[idx], self.v[idx]


def check_fits(n_pages: int, batch: int, n_new: int) -> None:
    """Raise ``ValueError`` where publishing ``n_new`` blocks of each of
    ``batch`` prompts needs more pages than the pool's ``n_pages``: one
    allocation would recycle its own pages (F12 in ROADMAP.md)."""
    if batch * n_new > n_pages:
        raise ValueError(
            f"publishing {batch} x {n_new} blocks needs more pages than the "
            f"pool's {n_pages}: one allocation would recycle its own pages "
            f"and serve a wrong page (F12 in ROADMAP.md)")


class PrefixCache:
    """Host-side coordinator tying the DHT to the page pool, both on
    ``device`` (the card unless the caller names another).
    ``round_stats`` keeps the engine stats of the last lookup and publish
    round (device tensors: reading them is the caller's sync)."""

    def __init__(self, model_cfg, n_pages=256, page_size=64,
                 dht_shards=1, dht_buckets=1 << 12, dtype=torch.bfloat16, *,
                 device=None):
        self.cfg = model_cfg
        self.page_size = page_size
        self.device = resolve_device(device)
        self.dht = dht_create(dht_config(dht_shards, dht_buckets),
                              device=self.device)
        self.pool = PagePool.create(
            n_pages, model_cfg.n_layers, page_size,
            model_cfg.n_kv_heads, model_cfg.head_dim, dtype, device=self.device)
        self.stats = {"block_hits": 0, "block_misses": 0, "stale": 0,
                      "published": 0}
        self.round_stats: dict = {}

    def _keys(self, prompts: np.ndarray) -> np.ndarray:
        return np.stack([chain_block_keys(p, self.page_size) for p in prompts])

    # -- lookup ------------------------------------------------------------
    def lookup(self, prompts: np.ndarray) -> tuple[int, np.ndarray]:
        """prompts: (B, S).  Returns (n_prefix_blocks, page_ids (B, n)):
        the longest block run cached for *all* requests (which keeps the
        batch rectangular).  One device-to-host read of the round's
        values and found flags."""
        b, s = prompts.shape
        n_blocks = s // self.page_size
        keys = self._keys(prompts)                    # (B, n_blocks, KW)
        self.dht, vals, found, st = dht_read(
            self.dht, _words(keys.reshape(-1, KEY_WORDS), self.device))
        self.round_stats["lookup"] = st
        host = torch.cat([vals, found[:, None].to(vals.dtype)], dim=1).cpu()
        host = host.numpy().view(np.uint32)
        vals = host[:, :VAL_WORDS].reshape(b, n_blocks, VAL_WORDS)
        found = host[:, VAL_WORDS].astype(bool).reshape(b, n_blocks)
        page_ids = vals[..., 0].astype(np.int64)
        gen = vals[..., 1].astype(np.int64)
        fresh = found & (gen == self.pool.gen[np.clip(page_ids, 0,
                                                      len(self.pool.gen) - 1)])
        self.stats["stale"] += int((found & ~fresh).sum())
        ok_run = 0
        for j in range(n_blocks):
            if fresh[:, j].all():
                ok_run += 1
            else:
                break
        self.stats["block_hits"] += ok_run * b
        self.stats["block_misses"] += (n_blocks - ok_run) * b
        return ok_run, page_ids[:, :ok_run].astype(np.int32)

    def fetch_prefix(self, page_ids: np.ndarray):
        """page_ids: (B, n).  Returns (pk (L,B,P,Hk,D), pv, p_pos (B,P))."""
        b, n = page_ids.shape
        if n == 0:
            return None
        kp, vp = self.pool.read(page_ids.reshape(-1))   # (B*n, L, ps, Hk, D)
        nl, ps = kp.shape[1], self.page_size

        def arrange(x):
            x = x.reshape(b, n, nl, ps, *x.shape[3:])
            return x.movedim(2, 0).reshape(nl, b, n * ps, *x.shape[4:])

        p_pos = torch.arange(n * ps, dtype=torch.int32,
                             device=self.device).expand(b, n * ps)
        return arrange(kp), arrange(vp), p_pos

    # -- publish -----------------------------------------------------------
    def publish(self, prompts: np.ndarray, start_block: int,
                ks: torch.Tensor, vs: torch.Tensor) -> None:
        """Publish suffix KV.  ks: (L, B, S_suf, Hk, D) from prefill_collect;
        the suffix starts at block ``start_block`` of each prompt."""
        nl, b, s_suf = ks.shape[:3]
        ps = self.page_size
        n_new = s_suf // ps
        if n_new == 0:
            return
        check_fits(len(self.pool.gen), b, n_new)
        keys = self._keys(prompts)                    # (B, n_blocks, KW)
        new_keys = keys[:, start_block:start_block + n_new].reshape(-1, KEY_WORDS)
        ids = self.pool.alloc(b * n_new)              # (B*n_new,)

        def pages(x):   # (L,B,S,Hk,D) -> (B*n_new, L, ps, Hk, D)
            x = x.reshape(nl, b, n_new, ps, *x.shape[3:]).movedim(0, 2)
            return x.reshape(b * n_new, nl, ps, *x.shape[4:])

        self.pool.write(ids, pages(ks), pages(vs))
        vals = np.zeros((b * n_new, VAL_WORDS), np.uint32)
        vals[:, 0] = ids.astype(np.uint32)
        vals[:, 1] = self.pool.gen[ids].astype(np.uint32)
        vals[:, 2] = new_keys[:, 0]
        self.dht, st = dht_write(self.dht, _words(new_keys, self.device),
                                 _words(vals, self.device))
        self.round_stats["publish"] = st
        self.stats["published"] += b * n_new
