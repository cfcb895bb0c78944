"""Elastic membership: a consistent-hash ring (PyTorch port of
``repro.core.membership``).

The paper's owner is the static ``hash % S``.  Here each shard projects
``n_virtual`` virtual nodes onto the 32-bit ring; a key is owned by the
shard of the successor vnode of its hash.  A membership change (join,
leave, resize) then relocates only the keys whose successor vnode
changed, which is what makes online resharding (``core/migrate.py``)
affordable.  Every change bumps ``epoch``; the engine stamps it on its
rounds, and the L1 tier stops serving lines of an older epoch.

Rings are built on the host (numpy), as the reference builds them; the
vnode positions come from the port's ``murmur32_words`` and equal the
reference's word for word.  A :class:`RingState` keeps its host arrays
and carries the lookup arrays as tensors: ``positions`` widened to int64
(``torch.searchsorted`` takes no uint32, and an int32 bit-view would
sort wrongly), ``owners`` and ``succ`` int32.  A fresh ring's tensors
sit on the CPU; attaching the ring to a table (``dht_create``,
``with_ring``) moves them to the table's device.  ``n_live`` and
``epoch`` are Python ints, so a round reads no ring scalar back from the
card.  Liveness is kept twice: ``alive`` on the host for planners, and
its device twin ``alive_dev``, which the replica select and the L1's
crash gate read, so a replicated round copies nothing from the host.  A
crash or a recovery (which flip liveness without rebuilding placement)
update the twin on its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .hashing import murmur32_words, ring_owner
from .layout import u32

# seed for vnode placement: independent of the key-hash seeds
SEED_RING = 0x7F4A7C15

# dead ring slots sort past every real position
DEAD_POSITION = np.uint32(0xFFFFFFFF)

# widest replica set the successor table precomputes (k <= MAX_REPLICAS)
MAX_REPLICAS = 4


@dataclasses.dataclass(frozen=True, eq=False)
class RingState:
    """Consistent-hash ring: placement, liveness and epoch.

    positions : (n_slots,) int64 tensor   sorted vnode positions in
                                          [0, 2^32) (dead slots 0xFFFFFFFF,
                                          at the tail)
    owners    : (n_slots,) int32 tensor   shard of each vnode (-1 dead)
    alive     : (S,) bool numpy           per-shard liveness
    alive_dev : (S,) bool tensor          the same, beside ``positions``
    n_live    : int                       live vnodes (prefix of positions)
    epoch     : int                       bumped on every membership change
    succ      : (n_slots, K) int32 tensor first K distinct shards walking
                                          the ring from each slot (column 0
                                          the owner, -1 pad); K =
                                          min(MAX_REPLICAS, S).  Built at
                                          rebuild time, so a crash (which
                                          flips ``alive`` only) keeps every
                                          key's replica set.
    host      : the same three arrays as numpy (uint32 positions), for the
                ``*_np`` twins, which never read the device.
    """

    positions: torch.Tensor
    owners: torch.Tensor
    alive: np.ndarray
    n_live: int
    epoch: int
    succ: torch.Tensor
    alive_dev: torch.Tensor
    n_virtual: int = 64
    host: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_shards(self) -> int:
        return int(self.alive.shape[0])

    @property
    def device(self) -> torch.device:
        return self.positions.device

    def to(self, device) -> "RingState":
        """This ring with its lookup tensors on ``device`` (itself when
        they are there already)."""
        device = torch.device(device)
        if self.positions.device == device:
            return self
        return dataclasses.replace(
            self, positions=self.positions.to(device),
            owners=self.owners.to(device), succ=self.succ.to(device),
            alive_dev=self.alive_dev.to(device))


def _vnode_positions(n_shards: int, n_virtual: int) -> np.ndarray:
    """(S, V) uint32 ring position of vnode (shard, replica)."""
    s = torch.arange(n_shards, dtype=torch.int32)[:, None]
    r = torch.arange(n_virtual, dtype=torch.int32)[None, :]
    words = torch.stack([s.expand(n_shards, n_virtual),
                         r.expand(n_shards, n_virtual)], dim=-1)
    return murmur32_words(words, SEED_RING).numpy().view(np.uint32)


def _successor_table(own: np.ndarray, n_live: int, k_max: int) -> np.ndarray:
    """(n_slots, k_max) int32: the first ``k_max`` distinct shards met
    walking the sorted ring clockwise from each live slot (column 0 is the
    slot's own owner); -1 pads.  Dead sentinel slots are all -1."""
    n_slots = own.shape[0]
    succ = np.full((n_slots, k_max), -1, np.int32)
    if n_live == 0:
        return succ
    live = own[:n_live]
    for i in range(n_live):
        found: list[int] = []
        for step in range(n_live):
            o = int(live[(i + step) % n_live])
            if o not in found:
                found.append(o)
                if len(found) == k_max:
                    break
        succ[i, : len(found)] = found
    return succ


def _from_host(pos: np.ndarray, own: np.ndarray, alive: np.ndarray,
               n_live: int, epoch: int, succ: np.ndarray,
               n_virtual: int) -> RingState:
    return RingState(
        positions=torch.from_numpy(pos.astype(np.int64)),
        owners=torch.from_numpy(own.astype(np.int32)),
        alive=alive, n_live=int(n_live), epoch=int(epoch),
        succ=torch.from_numpy(succ.astype(np.int32)),
        alive_dev=torch.from_numpy(alive.copy()), n_virtual=n_virtual,
        host={"positions": pos, "owners": own, "succ": succ})


def _rebuild(alive: np.ndarray, n_virtual: int, epoch: int) -> RingState:
    """Host-side ring construction: sort live vnodes, sentinel-pad dead."""
    n_shards = int(alive.shape[0])
    if not alive.any():
        raise ValueError("a ring needs at least one live shard")
    pos = _vnode_positions(n_shards, n_virtual)            # (S, V)
    own = np.broadcast_to(
        np.arange(n_shards, dtype=np.int32)[:, None], pos.shape).copy()
    dead = ~alive[:, None]
    pos = np.where(dead, DEAD_POSITION, pos).reshape(-1).astype(np.uint32)
    own = np.where(dead, np.int32(-1), own).reshape(-1).astype(np.int32)
    # stable sort: dead sentinels land at the tail
    order = np.argsort(pos, kind="stable")
    pos, own = pos[order], own[order]
    n_live = int(alive.sum()) * n_virtual
    k_max = min(MAX_REPLICAS, n_shards)
    return _from_host(pos, own, alive, n_live, epoch,
                      _successor_table(own, n_live, k_max), n_virtual)


def ring_create(n_shards: int, n_virtual: int = 64,
                alive: np.ndarray | None = None) -> RingState:
    """Fresh ring at epoch 0; all shards live unless ``alive`` says
    otherwise.  Its tensors sit on the CPU until a table takes it."""
    if alive is None:
        alive = np.ones((n_shards,), bool)
    return _rebuild(np.array(alive, bool), n_virtual, epoch=0)


def ring_owner_of(ring: RingState, h_hi: torch.Tensor) -> torch.Tensor:
    """Owner shard of each key hash (int32 bit-view words) under this
    ring, on the hashes' device."""
    r = ring.to(h_hi.device)
    return ring_owner(h_hi, r.positions, r.owners, r.n_live)


def ring_successors(ring: RingState, h_hi: torch.Tensor, k: int
                    ) -> torch.Tensor:
    """(..., k) int32 replica set of each key hash: the first k distinct
    shards walking the ring clockwise from the key's successor vnode.
    Column 0 is :func:`ring_owner_of`; -1 pads."""
    if not 1 <= k <= ring.succ.shape[1]:
        raise ValueError(f"k={k} out of range for {tuple(ring.succ.shape)}")
    r = ring.to(h_hi.device)
    idx = torch.searchsorted(r.positions, u32(h_hi), side="left")
    idx = torch.where(idx >= r.n_live, 0, idx)
    return r.succ[idx, :k]


def ring_successors_np(ring: RingState, h_hi: np.ndarray, k: int
                       ) -> np.ndarray:
    """numpy twin of :func:`ring_successors` for host planners."""
    if not 1 <= k <= ring.succ.shape[1]:
        raise ValueError(f"k={k} out of range for {tuple(ring.succ.shape)}")
    idx = np.searchsorted(ring.host["positions"],
                          np.asarray(h_hi).astype(np.uint32), side="left")
    idx = np.where(idx >= ring.n_live, 0, idx)
    return ring.host["succ"][idx, :k].astype(np.int32)


def ring_owner_np(ring: RingState, h_hi: np.ndarray) -> np.ndarray:
    """numpy twin of :func:`ring_owner_of` for host simulators."""
    idx = np.searchsorted(ring.host["positions"],
                          np.asarray(h_hi).astype(np.uint32), side="left")
    idx = np.where(idx >= ring.n_live, 0, idx)
    return ring.host["owners"][idx].astype(np.int32)


def _flip(ring: RingState, shard_id: int, to: bool) -> np.ndarray:
    alive = ring.alive.copy()
    if bool(alive[shard_id]) == to:
        raise ValueError(f"shard {shard_id} is already "
                         f"{'live' if to else 'down'}")
    alive[shard_id] = to
    return alive


def ring_leave(ring: RingState, shard_id: int) -> RingState:
    """Shard departs (graceful leave or declared failure): epoch + 1."""
    return _rebuild(_flip(ring, shard_id, False), ring.n_virtual,
                    epoch=ring.epoch + 1)


def ring_join(ring: RingState, shard_id: int) -> RingState:
    """Shard (re)joins: epoch + 1."""
    return _rebuild(_flip(ring, shard_id, True), ring.n_virtual,
                    epoch=ring.epoch + 1)


def _set_live(ring: RingState, alive: np.ndarray, shard_id: int
              ) -> RingState:
    """``ring`` with liveness ``alive`` (one bit flipped at ``shard_id``)
    and epoch + 1, placement kept; the device twin is updated on its
    device."""
    twin = ring.alive_dev.clone()
    twin[shard_id] = bool(alive[shard_id])
    return dataclasses.replace(ring, alive=alive, alive_dev=twin,
                               epoch=ring.epoch + 1)


def ring_crash(ring: RingState, shard_id: int) -> RingState:
    """Abrupt shard death: the liveness bit drops and the epoch bumps,
    WITHOUT rebuilding placement, so every key's owner and successor set
    stay as they were (readers gate on ``alive``); the epoch bump fences
    the L1 tier."""
    alive = _flip(ring, shard_id, False)
    if not alive.any():
        raise ValueError("cannot crash the last live shard")
    return _set_live(ring, alive, shard_id)


def ring_recover(ring: RingState, shard_id: int) -> RingState:
    """A crashed shard returns to its placement slot: liveness back on,
    epoch + 1."""
    return _set_live(ring, _flip(ring, shard_id, True), shard_id)


def ring_resize(ring: RingState, new_n_shards: int) -> RingState:
    """Ring for a grown or shrunk shard set (all live): epoch + 1.  Vnode
    positions hash only (shard, replica), so growth moves only the keys
    the new shards' vnodes capture."""
    return _rebuild(np.ones((new_n_shards,), bool), ring.n_virtual,
                    epoch=ring.epoch + 1)


def live_shards(ring: RingState) -> np.ndarray:
    """Host-side live shard ids."""
    return np.nonzero(ring.alive)[0]


__all__ = [
    "DEAD_POSITION", "MAX_REPLICAS", "RingState", "SEED_RING",
    "live_shards", "ring_crash", "ring_create", "ring_join", "ring_leave",
    "ring_owner_np", "ring_owner_of", "ring_recover", "ring_resize",
    "ring_successors", "ring_successors_np",
]
