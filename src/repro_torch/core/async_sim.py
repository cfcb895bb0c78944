"""Host-level async rank simulator (PyTorch port of
``repro.core.async_sim``; pure numpy, like the reference).

It reproduces the paper's torn-read / checksum-mismatch phenomenology
(Tables 2 and 4).  In the synchronous engine a read never sees a
half-written bucket; real one-sided RDMA can.  :class:`AsyncDHT`
simulates R ranks whose read and write *sub-operations* interleave: a
write is split into (a) publish the key and the first half of the value,
(b) publish the rest of the value, the checksum and the meta word.  A
reader scheduled between (a) and (b) sees a torn bucket; in lock-free
mode the checksum catches it (retry, then flag INVALID); in the locked
modes the lock prevents it, at a serialization cost counted in round
trips.

:class:`IssueCommitOracle` is the flat-dict twin of the engine's
issue/commit split (``core/op_engine.dht_issue``/``dht_commit``): a
round's *effects* land at issue time, its *results* materialize at
commit time, so a read issued after an uncommitted write to the same key
observes it.  The interleaving tests drive the engine against it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .layout import GEN_SHIFT, INVALID, OCCUPIED, DHTConfig
from .membership import ring_owner_np

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_MASK = 0xFFFFFFFF


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def _murmur32_np(words: np.ndarray, seed: int) -> np.ndarray:
    """numpy twin of the murmur3 word hash of ``core/hashing.py``
    (words: (..., W))."""
    h = np.full(words.shape[:-1], seed & _MASK, dtype=np.uint64)
    for i in range(words.shape[-1]):
        k = words[..., i].astype(np.uint64)
        k = (k * _C1) & _MASK
        k = _rotl(k, 15)
        k = (k * _C2) & _MASK
        h ^= k
        h = _rotl(h, 13)
        h = (h * 5 + 0xE6546B64) & _MASK
    h ^= words.shape[-1] * 4
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _MASK
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _MASK
    h ^= h >> 16
    return h.astype(np.uint32)


def checksum_np(key_words: np.ndarray, val_words: np.ndarray) -> np.ndarray:
    return _murmur32_np(
        np.concatenate([key_words, val_words], axis=-1), 0xB5297A4D
    )


def hash64_np(key_words: np.ndarray):
    return (
        _murmur32_np(key_words, 0x9E3779B9),
        _murmur32_np(key_words, 0x85EBCA77),
    )


@dataclasses.dataclass
class AsyncStats:
    reads: int = 0
    writes: int = 0
    hits: int = 0
    mismatches: int = 0        # checksum divergence observed (lock-free)
    retries: int = 0
    invalidated: int = 0
    torn_exposures: int = 0    # reader scheduled against a half-done write
    lock_round_trips: int = 0  # serialization cost of the locked modes


class AsyncDHT:
    """R concurrent ranks over one shared table, interleaved sub-ops.
    Owners are the static ``hash % S``, or with ``ring`` (a
    ``core.membership.RingState``) the ring's successor vnode, through
    its host arrays: the torn-read phenomenology does not depend on
    placement."""

    def __init__(self, cfg: DHTConfig, seed: int = 0, ring=None):
        self.cfg = cfg
        self.ring = ring
        b = cfg.n_shards * cfg.buckets_per_shard
        self.keys = np.zeros((b, cfg.key_words), np.uint32)
        self.vals = np.zeros((b, cfg.val_words), np.uint32)
        self.meta = np.zeros((b,), np.uint32)
        self.csum = np.zeros((b,), np.uint32)
        self.rng = np.random.default_rng(seed)
        self.stats = AsyncStats()
        # in-flight write second-halves: list of (bucket, key, val, csum)
        self.pending: list[tuple[int, np.ndarray, np.ndarray, int]] = []

    # -- addressing (same scheme as the engine) --
    def _bucket_of(self, key: np.ndarray) -> int:
        h_hi, h_lo = hash64_np(key[None, :])
        if self.ring is not None:
            shard = int(ring_owner_np(self.ring, h_hi)[0])
        else:
            shard = int(h_hi[0]) % self.cfg.n_shards
        span = max(self.cfg.buckets_per_shard - self.cfg.n_probe + 1, 1)
        base = int(h_lo[0]) % span
        return shard * self.cfg.buckets_per_shard + base

    def _probe(self, key: np.ndarray):
        b0 = self._bucket_of(key)
        for j in range(self.cfg.n_probe):
            b = b0 + j
            occ = self.meta[b] & OCCUPIED
            inv = self.meta[b] & INVALID
            if occ and not inv and np.array_equal(self.keys[b], key):
                return b, "match"
        for j in range(self.cfg.n_probe):
            b = b0 + j
            if not (self.meta[b] & OCCUPIED) or (self.meta[b] & INVALID):
                return b, "empty"
        return b0 + self.cfg.n_probe - 1, "evict"

    # -- sub-op interleaving --
    def write_begin(self, key: np.ndarray, val: np.ndarray):
        """Sub-op (a): key + first half of the value land."""
        b, _kind = self._probe(key)
        half = self.cfg.val_words // 2
        self.keys[b] = key
        self.vals[b, :half] = val[:half]
        gen = (self.meta[b] >> GEN_SHIFT) + 1
        self.meta[b] = OCCUPIED | (gen << GEN_SHIFT)
        # checksum NOT yet updated -> bucket is torn until write_commit
        cs = int(checksum_np(key[None], val[None])[0])
        self.pending.append((b, key.copy(), val.copy(), cs))
        self.stats.writes += 1
        if self.cfg.mode in ("fine", "coarse"):
            self.stats.lock_round_trips += 2

    def write_commit(self):
        """Sub-op (b): rest of value + checksum published."""
        if not self.pending:
            return
        b, key, val, cs = self.pending.pop(0)
        half = self.cfg.val_words // 2
        self.vals[b, half:] = val[half:]
        self.csum[b] = cs
        self.meta[b] &= ~np.uint32(INVALID)

    def read(self, key: np.ndarray):
        self.stats.reads += 1
        if self.cfg.mode in ("fine", "coarse"):
            # locks forbid reading torn buckets: behave as if serialized
            self.stats.lock_round_trips += 2
            for _ in range(len(self.pending)):
                self.write_commit()
        b, kind = self._probe(key)
        if kind != "match":
            return None
        torn = any(p[0] == b for p in self.pending)
        if torn:
            self.stats.torn_exposures += 1
        if self.cfg.mode == "lockfree":
            for attempt in range(self.cfg.max_read_retries + 1):
                cs = checksum_np(self.keys[b][None], self.vals[b][None])
                ok = int(cs[0]) == int(self.csum[b])
                if ok:
                    if attempt > 0:
                        self.stats.retries += attempt
                    self.stats.hits += 1
                    return self.vals[b].copy()
                self.stats.mismatches += 1
                # model: the racing writer may complete between retries
                if self.pending and self.rng.random() < 0.5:
                    self.write_commit()
            self.meta[b] |= INVALID
            self.stats.invalidated += 1
            return None
        self.stats.hits += 1
        return self.vals[b].copy()


class IssueCommitOracle:
    """Flat-dict twin of the issue/commit protocol.

    Models exactly the semantics the split engine promises:

    - ``issue_write`` applies at ISSUE time — later reads (issued or
      committed in any order afterwards) observe it, because the
      engine enqueues every slab access of a round at issue and the
      card's stream runs them in issue order.
    - ``issue_read`` snapshots at ISSUE time — a commit delayed
      arbitrarily long returns what the table held when the round was
      issued, never a later write.
    - ``commit`` only materializes; it has no effect on the table, and
      committing out of issue order changes nothing (the FIFO rule of
      the real engine exists only for the pending-write *forwarding*
      bookkeeping, not for state semantics).

    The interleaving tests drive random ``dht_issue``/``dht_commit``
    schedules against this oracle; the promised-write hazard is the one
    case where the real engine needs extra machinery
    (``core.pipeline.PendingWrites``) to meet the oracle's answer.

    **Replication / crash transitions.**  With a ``placement`` function
    the caller passes in (key row -> ordered tuple of its k replica
    shards, such as a ring's k successors), the oracle also models the
    k-successor replication protocol under the engine's write-once
    get-or-put semantics:

    - a write lands copies on the LIVE members of the key's replica set
      (a dead successor simply misses its copy until repair);
    - a read is served by the first live shard in successor order — the
      owner unless its liveness bit is down — and finds the key iff that
      *serving* shard holds a copy.  A recovered-but-unrepaired owner
      therefore misses keys its successors still hold: the documented
      availability gap anti-entropy repair closes (under write-once
      semantics the miss triggers a bit-identical recompute, so this is
      an efficiency gap, never an inconsistency);
    - ``crash`` wipes the shard's copies; a key whose LAST copy dies is
      lost (as it is for real — k-1 simultaneous failures are the
      design's tolerance bound);
    - ``repair`` re-replicates every surviving key whose replica set
      covers the shard: the oracle twin of anti-entropy repair.
    """

    def __init__(self, n_shards: int = 0, placement=None):
        self.table: dict[bytes, np.ndarray] = {}
        self.holders: dict[bytes, set[int]] = {}
        self.alive: list[bool] = [True] * int(n_shards)
        self.placement = placement
        self._seq = 0

    @staticmethod
    def _row(key) -> bytes:
        return np.ascontiguousarray(
            np.asarray(key, dtype=np.uint32)).tobytes()

    def _serving(self, row: bytes, key) -> bool:
        """Replica-aware visibility: does the shard that would SERVE a
        read of ``key`` (first live successor, owner first) hold a copy?
        Placement-free oracles reduce to plain presence."""
        if self.placement is None:
            return row in self.table
        if row not in self.table:
            return False
        for s in self.placement(key):
            if s >= 0 and self.alive[s]:
                return s in self.holders.get(row, ())
        return False

    def issue_read(self, keys: np.ndarray):
        """Snapshot the keys now; returns a handle for :meth:`commit`."""
        ks = np.asarray(keys)
        vals = [self.table.get(self._row(k))
                if self._serving(self._row(k), k) else None for k in ks]
        self._seq += 1
        return ("read", self._seq,
                [None if v is None else v.copy() for v in vals])

    def issue_write(self, keys: np.ndarray, vals: np.ndarray):
        """Apply now (issue-order semantics); handle carries the count.
        With placement, copies land on the live replica-set members."""
        keys, vals = np.asarray(keys), np.asarray(vals)
        for k, v in zip(keys, vals):
            row = self._row(k)
            if self.placement is not None:
                live = {s for s in self.placement(k)
                        if s >= 0 and self.alive[s]}
                if not live:
                    continue  # whole replica set down: nothing acks
                self.holders[row] = self.holders.get(row, set()) | live
            self.table[row] = np.asarray(v, np.uint32).copy()
        self._seq += 1
        return ("write", self._seq, len(keys))

    def commit(self, handle):
        """Materialize an issued round's results: ``(vals, found)`` row
        lists for reads, the written count for writes."""
        kind, _seq, payload = handle
        if kind == "read":
            return payload, [v is not None for v in payload]
        return payload

    # -- crash / recover / repair transitions (placement mode) ------------
    def crash(self, shard: int) -> None:
        """Abrupt death: the shard's copies are wiped; keys whose last
        copy dies are lost (beyond the k-1 failure tolerance)."""
        assert self.placement is not None, "crash needs a placement model"
        self.alive[shard] = False
        for row in list(self.holders):
            self.holders[row].discard(shard)
            if not self.holders[row]:
                del self.holders[row]
                self.table.pop(row, None)

    def recover(self, shard: int) -> None:
        """The shard returns, empty; :meth:`repair` re-converges it."""
        assert self.placement is not None, "recover needs a placement model"
        self.alive[shard] = True

    def repair(self, shard: int, keys) -> int:
        """Anti-entropy: re-replicate every surviving key whose replica
        set covers ``shard``.  ``keys`` enumerates the candidate key rows
        (the oracle stores only hashed rows, so the caller supplies the
        originals).  Returns the healed-copy count."""
        assert self.placement is not None, "repair needs a placement model"
        healed = 0
        for k in np.asarray(keys):
            row = self._row(k)
            if row not in self.table or row not in self.holders:
                continue
            if shard in tuple(self.placement(k)) \
                    and shard not in self.holders[row]:
                self.holders[row].add(shard)
                healed += 1
        return healed


def run_mixed_workload(
    cfg: DHTConfig,
    n_ranks: int,
    ops_per_rank: int,
    read_fraction: float = 0.95,
    dist: str = "zipf",
    zipf_skew: float = 0.99,
    key_range: int = 712_500,
    seed: int = 0,
) -> AsyncStats:
    """Paper §5.2 second experiment under interleaved async execution."""
    rng = np.random.default_rng(seed)
    table = AsyncDHT(cfg, seed)
    kw = cfg.key_words
    n_ops = n_ranks * ops_per_rank

    if dist == "zipf":
        ids = rng.zipf(zipf_skew + 1.0, size=n_ops) % key_range
    else:
        ids = rng.integers(0, key_range, size=n_ops)
    is_read = rng.random(n_ops) < read_fraction

    def key_of(i: int) -> np.ndarray:
        k = np.zeros((kw,), np.uint32)
        k[0] = np.uint32(i & _MASK)
        k[1] = np.uint32((i >> 32) & _MASK)
        return k

    for i in range(n_ops):
        key = key_of(int(ids[i]))
        if is_read[i]:
            table.read(key)
        else:
            val = rng.integers(0, 2**31, size=cfg.val_words).astype(np.uint32)
            table.write_begin(key, val)
            # async exposure window: the commit may be delayed past the next
            # rank's operation (one-sided RDMA completes out of program order)
            if rng.random() < 0.7:
                table.write_commit()
        # occasionally flush stragglers
        if rng.random() < 0.3:
            table.write_commit()
    while table.pending:
        table.write_commit()
    return table.stats
