"""Bucket slab layout for the sharded DHT (PyTorch port of ``repro.core.layout``).

Struct-of-arrays layout, one dense tensor per field:

  keys : (S, B, KW) int32    key words        (POET: 80 B  -> KW = 20)
  vals : (S, B, VW) int32    value words      (POET: 104 B -> VW = 26)
  meta : (S, B)     int32    bit0 OCCUPIED, bit1 INVALID, bits8+ generation
  csum : (S, B)     int32    lock-free checksum over key||value

Words are int32 *bit-views* of the reference's uint32 words: torch's
uint32 is storage-only (no ``+ >> << %`` or ``argmax``), so every
arithmetic step that needs unsigned semantics widens to int64 and masks to
32 bits (:func:`u32`, :func:`to_i32`).

Each field lives in a flat buffer with ONE extra trailing row, the dump
row: index writes that must skip an item (the reference's
``mode="drop"`` scatters) aim it there instead.  ``state.keys`` & co. are
(S, B, ...) views that exclude it.  The engine updates the buffers in
place, so a state passed to ``dht_execute`` is the state it returns;
clone it (:meth:`DHTState.clone`) to keep a snapshot.

A state may hold fewer shards than ``cfg.n_shards``: on the multi-rank
backend (``core/distributed.py``) each rank holds one shard's B rows
while ``cfg`` keeps the global S that the owner hash ``hi % S`` needs.
The views take their leading dim from the buffers' rows
(:attr:`DHTState.n_local`), never from ``cfg.n_shards``.

A state may carry a consistent-hash ring (``core/membership.py``): the
owner is then the ring's successor vnode instead of ``hi % S``.  Its
lookup tensors live on the table's device.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

OCCUPIED = 1
INVALID = 2
GEN_SHIFT = 8

MODE_LOCKFREE = "lockfree"
MODE_FINE = "fine"
MODE_COARSE = "coarse"
MODES = (MODE_LOCKFREE, MODE_FINE, MODE_COARSE)

MASK32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit-view -> int64 holding the unsigned value in [0, 2^32)."""
    return x.to(torch.int64) & MASK32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 (any value) -> int32 bit-view of its low 32 bits."""
    return (((x + 0x80000000) & MASK32) - 0x80000000).to(torch.int32)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The port runs on the card unless the caller names another device.
    Asking for CUDA where there is none raises: nothing falls back to the
    CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class DHTConfig:
    """Static configuration (same fields and defaults as the reference)."""

    key_words: int = 20          # 80-byte keys (paper / POET)
    val_words: int = 26          # 104-byte values
    n_shards: int = 1            # S
    buckets_per_shard: int = 1024  # B
    n_probe: int = 6             # candidate window size
    mode: str = MODE_LOCKFREE
    capacity: int = 0            # routing capacity per destination; 0 = auto
    max_read_retries: int = 2
    n_replicas: int = 1

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.n_probe < 1 or self.buckets_per_shard < self.n_probe:
            raise ValueError("need 1 <= n_probe <= buckets_per_shard")
        if not 1 <= self.n_replicas <= min(self.n_shards, 4):
            raise ValueError(f"n_replicas {self.n_replicas} out of range")

    @property
    def bucket_bytes(self) -> int:
        return 4 * (self.key_words + self.val_words + 2)

    @property
    def shard_bytes(self) -> int:
        return self.bucket_bytes * self.buckets_per_shard


@dataclasses.dataclass(eq=False)
class DHTState:
    """The table: flat field buffers of ``n_local * B`` rows plus the
    dump row (``n_local`` is S, or 1 on a rank of the multi-rank
    backend)."""

    cfg: DHTConfig
    flat_keys: torch.Tensor   # (S*B + 1, KW) int32
    flat_vals: torch.Tensor   # (S*B + 1, VW) int32
    flat_meta: torch.Tensor   # (S*B + 1,) int32
    flat_csum: torch.Tensor   # (S*B + 1,) int32
    ring: Any = None          # membership.RingState, None = hi % S

    @property
    def device(self) -> torch.device:
        return self.flat_keys.device

    @property
    def n_local(self) -> int:
        """Shards held by these buffers: S, or 1 on a rank."""
        return (self.flat_meta.shape[0] - 1) // self.cfg.buckets_per_shard

    @property
    def keys(self) -> torch.Tensor:
        c = self.cfg
        return self.flat_keys[:-1].view(self.n_local, c.buckets_per_shard,
                                        c.key_words)

    @property
    def vals(self) -> torch.Tensor:
        c = self.cfg
        return self.flat_vals[:-1].view(self.n_local, c.buckets_per_shard,
                                        c.val_words)

    @property
    def meta(self) -> torch.Tensor:
        c = self.cfg
        return self.flat_meta[:-1].view(self.n_local, c.buckets_per_shard)

    @property
    def csum(self) -> torch.Tensor:
        c = self.cfg
        return self.flat_csum[:-1].view(self.n_local, c.buckets_per_shard)

    def clone(self) -> "DHTState":
        return DHTState(self.cfg, self.flat_keys.clone(),
                        self.flat_vals.clone(), self.flat_meta.clone(),
                        self.flat_csum.clone(), self.ring)


def _attach(ring, cfg: DHTConfig, device: torch.device):
    """``ring`` on the table's device, checked against its shard count."""
    if ring is None:
        return None
    if ring.n_shards > cfg.n_shards:
        raise ValueError(f"a ring of {ring.n_shards} shards does not fit "
                         f"a table of {cfg.n_shards}")
    return ring.to(device)


def dht_create(cfg: DHTConfig, ring=None, *,
               device: str | torch.device | None = None,
               shards: int | None = None) -> DHTState:
    """DHT_create: allocate the empty table on ``device`` (CUDA unless
    the caller asks for another).  ``ring`` (a
    ``membership.RingState``) places keys on a consistent-hash ring
    instead of ``hi % S``.  ``shards`` is how many of the
    ``cfg.n_shards`` shards this process holds (default all; a rank of
    the multi-rank backend holds 1)."""
    dev = resolve_device(device)
    n_local = cfg.n_shards if shards is None else int(shards)
    if not 1 <= n_local <= cfg.n_shards:
        raise ValueError(f"shards={shards} out of range for "
                         f"n_shards={cfg.n_shards}")
    rows = n_local * cfg.buckets_per_shard + 1
    z = dict(dtype=torch.int32, device=dev)
    return DHTState(
        cfg=cfg,
        flat_keys=torch.zeros((rows, cfg.key_words), **z),
        flat_vals=torch.zeros((rows, cfg.val_words), **z),
        flat_meta=torch.zeros((rows,), **z),
        flat_csum=torch.zeros((rows,), **z),
        ring=_attach(ring, cfg, dev),
    )


def with_ring(state: DHTState, ring) -> DHTState:
    """The same buffers under another membership ring (None: ``hi %
    S``); the slabs are not copied."""
    return DHTState(state.cfg, state.flat_keys, state.flat_vals,
                    state.flat_meta, state.flat_csum,
                    _attach(ring, state.cfg, state.device))


def dht_free(state: DHTState) -> None:
    """DHT_free: drop this state's references to its buffers (they become
    empty).  Memory is returned once nothing else holds it: a state or
    view that shares the buffers keeps them alive and unchanged."""
    for name in ("flat_keys", "flat_vals", "flat_meta", "flat_csum"):
        buf = getattr(state, name)
        setattr(state, name, buf.new_empty((0,) + tuple(buf.shape[1:])))


def live_mask(meta: torch.Tensor) -> torch.Tensor:
    """Bucket liveness: occupied and not INVALID."""
    return ((meta & OCCUPIED) != 0) & ((meta & INVALID) == 0)


def shard_watermark(meta: torch.Tensor) -> torch.Tensor:
    """uint32 sum of a slab's meta words over the bucket axis, wrapped
    explicitly: ((B,) -> (), (S, B) -> (S,)), as an int64 in [0, 2^32).
    The int32 view is summed in int64: a sum mod 2^32 is the same for the
    signed and the unsigned view, and no int64 copy of ``meta`` is made."""
    return meta.sum(dim=-1, dtype=torch.int64) & MASK32


def occupancy(state: DHTState) -> torch.Tensor:
    """Fraction of occupied (and valid) buckets, per shard."""
    return live_mask(state.meta).to(torch.float32).mean(dim=-1)


def dht_occupancy(state: DHTState) -> dict[str, torch.Tensor]:
    """Per-shard OCCUPIED/INVALID/live counts and load factor."""
    m = state.meta
    occ = (m & OCCUPIED) != 0
    inv = (m & INVALID) != 0
    live = live_mask(m)
    return {
        "occupied_per_shard": occ.sum(dim=-1).to(torch.int32),
        "invalid_per_shard": inv.sum(dim=-1).to(torch.int32),
        "live_per_shard": live.sum(dim=-1).to(torch.int32),
        "load_factor_per_shard": live.to(torch.float32).mean(dim=-1),
        "load_factor": live.to(torch.float32).mean(),
        "buckets_per_shard": state.cfg.buckets_per_shard,
    }


def pack_floats(x: torch.Tensor, n_words: int) -> torch.Tensor:
    """Bitcast (..., k) float32 into (..., n_words) int32 words, zero
    padded: each float takes an even word slot (value word + zero word),
    the paper's 80-byte key layout for 10 values."""
    u = x.to(torch.float32).contiguous().view(torch.int32)
    out = torch.zeros(x.shape[:-1] + (n_words,), dtype=torch.int32,
                      device=x.device)
    take = min(n_words, 2 * u.shape[-1])
    n_vals = (take + 1) // 2
    out[..., 0:take:2] = u[..., :n_vals]
    return out


def unpack_floats(w: torch.Tensor, n_floats: int) -> torch.Tensor:
    """Inverse of :func:`pack_floats`."""
    return w[..., 0:2 * n_floats:2].contiguous().view(torch.float32)
