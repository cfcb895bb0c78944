"""Online resharding: plan and run the migration of live entries between
membership epochs (PyTorch port of the migration half of
``repro.core.migrate``).

- :func:`plan_migration` hashes every stored key (the ``hash64`` kernel
  over all S*B rows), looks up its owner on the new ring and keeps the
  live entries whose owner changes: with vnode placement about 1/S of
  the table per membership change.  It stays on the device; only the
  counts come back to the host.
- :func:`migration_begin` / :func:`migration_step` /
  :func:`migration_finish` move the planned entries in bounded batches,
  each ONE get-or-put (``OP_MIGRATE``) round of the op-engine: a key
  written in the new epoch since the migration began is never clobbered
  by its stale copy, and the presence check and the insert cost one
  round.
- Reads between begin and finish go through :func:`migration_read`
  (``dht.dht_read_dual``): each key fans out to its new- and old-epoch
  owners in one round, so an entry in flight is always found.
- :func:`migration_finish` retires the old placement: a source bucket is
  reclaimed only where the key stored there still belongs elsewhere (a
  fresh write to the same bucket survives), and on a shrink the
  evacuated rows are freed.

The port updates tables in place, where the reference's arrays are
immutable.  So :func:`migration_begin` gives the new epoch buffers of its
own, a padded copy of the old slab even when the shard count does not
change: the old epoch stays frozen as the dual-read fallback and as the
source of the moved rows (a migrate insert can never evict a source
bucket that has not moved yet, nor change what a dual read sees in the
old epoch).

Conveniences: :func:`dht_resize` (S -> S' shards), :func:`shard_leave`,
:func:`shard_join`, :func:`adopt_ring` (modulo -> ring placement).

Anti-entropy repair: after a crashed shard recovers
(``faults.recover_shard``) its slab is empty but its replica
responsibilities are unchanged (a crash never rebuilt placement), so
every key whose successor set holds the shard has surviving copies on
the other successors.  :func:`plan_repair` enumerates exactly those
keys on the device (``hash64`` over all S*B stored keys, the successor
lookup, the live mask), dedupes replica copies of one key (the first
flat slot wins) and drops the keys already present in the recovered
shard's probe window (one ``probe`` launch without checksum
validation).  :func:`repair_step` streams them back in bounded
get-or-put rounds pinned to the shard; :func:`repair_diff` is the
convergence check (0 when healed).
"""
from __future__ import annotations

import dataclasses
import time

import torch

from ..kernels import ops as kops
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .dht import dht_read_dual
from .hashing import base_bucket
from .layout import (
    MASK32,
    DHTConfig,
    DHTState,
    dht_create,
    dht_free,
    live_mask,
)
from .membership import (
    RingState,
    ring_create,
    ring_join,
    ring_leave,
    ring_owner_of,
    ring_resize,
    ring_successors,
)
from .op_engine import W_EVICT, _probe_window, dht_execute, migrate_ops

DEFAULT_BATCH = 256


def _owners(keys: torch.Tensor, ring: RingState) -> torch.Tensor:
    """New owner of each (M, KW) stored key row (the ``hash64`` kernel
    on the card)."""
    return ring_owner_of(ring, kops.hash64(keys.contiguous())[:, 0])


@dataclasses.dataclass(frozen=True)
class MigrationPlan:
    """Which occupied buckets must move, and into what table geometry."""

    new_cfg: DHTConfig      # cfg of the table after migration_finish
    mig_cfg: DHTConfig      # cfg during migration (slab rows = shard union)
    new_ring: RingState
    src: torch.Tensor       # (M,) int64 flat src bucket ids (shard*B + b)
    inplace: bool           # True: carry the slabs, move only `src`
    n_live: int             # live entries before migration

    @property
    def n_moved(self) -> int:
        return int(self.src.shape[0])


def plan_migration(state: DHTState, new_ring: RingState,
                   new_cfg: DHTConfig | None = None) -> MigrationPlan:
    """Decide the strategy and enumerate the entries to move.

    Same bucket geometry (B, n_probe, word widths): **in place**, the
    slabs are carried over (rows = the union of the old and new shard
    sets) and only owner-changed entries move.  Other geometry:
    **rebuild**, a fresh table and every live entry re-inserted.  On the
    device: the live mask, ``hash64`` over all S*B stored keys, the ring
    lookup and one ``nonzero``; two numbers come back to the host."""
    cfg = state.cfg
    if state.n_local != cfg.n_shards:
        raise ValueError("plan_migration needs the whole table (the "
                         "multi-rank backend plans per rank: "
                         "ShardedDHT.apply_ring)")
    if new_cfg is None:
        new_cfg = dataclasses.replace(cfg, n_shards=new_ring.n_shards)
    if new_cfg.n_shards != new_ring.n_shards:
        raise ValueError(f"cfg of {new_cfg.n_shards} shards, ring of "
                         f"{new_ring.n_shards}")
    inplace = (new_cfg.buckets_per_shard == cfg.buckets_per_shard
               and new_cfg.n_probe == cfg.n_probe
               and new_cfg.key_words == cfg.key_words
               and new_cfg.val_words == cfg.val_words)
    live = live_mask(state.meta).reshape(-1)
    if inplace:
        s, b = cfg.n_shards, cfg.buckets_per_shard
        row = torch.arange(s, dtype=torch.int32,
                           device=live.device).repeat_interleave(b)
        owner = _owners(state.flat_keys[:-1], new_ring)
        move = live & (owner != row)
        mig_rows = max(cfg.n_shards, new_cfg.n_shards)
    else:
        move = live
        mig_rows = new_cfg.n_shards
    src = torch.nonzero(move).reshape(-1)
    # migration-time cfg: the row union keeps old rows addressable as
    # sources; application traffic keeps its own routing capacity
    return MigrationPlan(
        new_cfg=new_cfg,
        mig_cfg=dataclasses.replace(new_cfg, n_shards=mig_rows),
        new_ring=new_ring, src=src, inplace=inplace,
        n_live=int(live.sum()))


@dataclasses.dataclass
class Migration:
    """An in-flight resharding: old epoch (frozen) + new epoch (filling)."""

    plan: MigrationPlan
    old: DHTState           # previous epoch: dual-read fallback, row source
    new: DHTState           # new epoch being populated (its own buffers)
    batch: int = DEFAULT_BATCH
    cursor: int = 0         # next index into plan.src
    moved: int = 0          # entries inserted into the new epoch
    skipped: int = 0        # stale copies superseded by mid-migration writes
    evicted: int = 0        # resident entries displaced at the destination

    @property
    def done(self) -> bool:
        return self.cursor >= self.plan.n_moved


def _resized(buf: torch.Tensor, rows: int) -> torch.Tensor:
    """A new flat buffer of ``rows`` slab rows plus a zero dump row
    holding ``buf``'s first rows (zero padded)."""
    out = buf.new_zeros((rows + 1,) + tuple(buf.shape[1:]))
    n = min(rows, buf.shape[0] - 1)
    out[:n] = buf[:n]
    return out


def _with_rows(state: DHTState, cfg: DHTConfig, ring) -> DHTState:
    """``state``'s slab in buffers of its own, ``cfg.n_shards`` shards."""
    rows = cfg.n_shards * cfg.buckets_per_shard
    return DHTState(cfg, _resized(state.flat_keys, rows),
                    _resized(state.flat_vals, rows),
                    _resized(state.flat_meta, rows),
                    _resized(state.flat_csum, rows),
                    None if ring is None else ring.to(state.device))


def migration_begin(state: DHTState, new_ring: RingState,
                    new_cfg: DHTConfig | None = None,
                    batch: int = DEFAULT_BATCH) -> Migration:
    """Plan and open the new epoch.  ``state`` stays frozen as the
    dual-read fallback: the new epoch is a padded copy of it (in place)
    or an empty table (rebuild)."""
    plan = plan_migration(state, new_ring, new_cfg)
    if plan.inplace:
        new = _with_rows(state, plan.mig_cfg, new_ring)
    else:
        new = dht_create(plan.mig_cfg, new_ring, device=state.device)
    return Migration(plan=plan, old=state, new=new, batch=batch)


def migration_step(mig: Migration) -> tuple[Migration, dict[str, int]]:
    """Move one bounded batch in ONE get-or-put round of the op-engine.
    Reads the round's counts back to the host once."""
    plan = mig.plan
    if mig.done:
        return mig, {"moved": 0, "skipped": 0, "evicted": 0, "remaining": 0}
    t0 = time.perf_counter()
    lo = mig.cursor
    hi = min(lo + mig.batch, plan.n_moved)
    n = hi - lo
    dev = plan.src.device
    pad = torch.zeros(mig.batch, dtype=torch.int64, device=dev)
    pad[:n] = plan.src[lo:hi]
    valid = torch.arange(mig.batch, device=dev) < n
    keys = mig.old.flat_keys[pad]
    vals = mig.old.flat_vals[pad]

    # migration traffic clears the application's capacity so the
    # count-exchange prologue sizes the round to its real largest bin
    # (nothing drops), without narrowing concurrent application rounds
    new = mig.new
    st = DHTState(dataclasses.replace(new.cfg, capacity=0), new.flat_keys,
                  new.flat_vals, new.flat_meta, new.flat_csum, new.ring)
    # OP_MIGRATE = presence check + insert in one round: a key already
    # (re)written in the new epoch wins over its stale copy (W_SKIP)
    _, _, _vals, found, code, es = dht_execute(
        st, migrate_ops(keys, vals, valid), kinds=("migrate",))
    dropped, stepped, skipped, evicted = torch.stack([
        es["dropped"].to(torch.int64), (valid & ~found).sum(),
        (valid & found).sum(), (code == W_EVICT).sum()]).tolist()
    if dropped:
        raise RuntimeError(f"migration round dropped {dropped} rows")
    mig.cursor = hi
    mig.moved += stepped
    mig.skipped += skipped
    mig.evicted += evicted
    obs_metrics.inc("migrate.steps")
    obs_metrics.inc("migrate.moved", stepped)
    obs_metrics.inc("migrate.skipped", skipped)
    obs_metrics.inc("migrate.evicted", evicted)
    step = {"moved": stepped, "skipped": skipped, "evicted": evicted,
            "remaining": plan.n_moved - mig.cursor}
    # the engine round recorded itself; this event wraps it with the
    # migration's accounting
    obs_trace.record_event("migrate.step", step, t_start=t0,
                           ops={"migrate": n})
    return mig, step


def migration_read(mig: Migration, keys: torch.Tensor, valid=None):
    """Dual-epoch read while the migration is in flight -> ``(mig, vals,
    found, stats)``."""
    mig.new, mig.old, vals, found, stats = dht_read_dual(mig.new, mig.old,
                                                         keys, valid)
    return mig, vals, found, stats


def stale_sources(keys: torch.Tensor, src: torch.Tensor, new_ring: RingState,
                  buckets_per_shard: int, shard_offset: int = 0):
    """The retire rule both backends share: of the planned source
    buckets, reclaim only those whose *currently stored* key still
    belongs to another shard (a bucket re-taken by a fresh write of a key
    owned here must survive).

    ``keys``: (rows, B, KW) slab of the new epoch; ``src`` flat bucket
    ids into it; ``shard_offset`` the global id of its row 0 (a rank's
    one shard).  Returns device tensors ``(shard_idx, bucket_idx,
    foreign)`` over ``src``."""
    s_idx = (src // buckets_per_shard).to(torch.int32) + shard_offset
    b_idx = (src % buckets_per_shard).to(torch.int32)
    stored = keys.reshape(-1, keys.shape[-1])[src]
    return s_idx, b_idx, _owners(stored, new_ring) != s_idx


def _retire(state: DHTState, src: torch.Tensor, ring: RingState,
            shard_offset: int = 0) -> None:
    """Zero meta and checksum of the stale sources, in place."""
    if not src.numel():
        return
    _, _, foreign = stale_sources(state.keys, src, ring,
                                  state.cfg.buckets_per_shard, shard_offset)
    dump = state.flat_meta.shape[0] - 1
    slot = torch.where(foreign, src, dump)
    state.flat_meta[slot] = 0
    state.flat_csum[slot] = 0


def migration_finish(mig: Migration) -> tuple[DHTState, dict[str, int]]:
    """Retire the previous epoch: reclaim stale source buckets, shrink the
    slab to the new shard set, restore the application cfg.  The old
    epoch's state is freed (``dht_free``): use the returned one."""
    if not mig.done:
        raise RuntimeError(
            f"{mig.plan.n_moved - mig.cursor} entries still in flight")
    plan = mig.plan
    new = mig.new
    if plan.inplace:
        _retire(new, plan.src, plan.new_ring)
    dht_free(mig.old)
    rows = plan.new_cfg.n_shards
    if new.n_local == rows:
        final = DHTState(plan.new_cfg, new.flat_keys, new.flat_vals,
                         new.flat_meta, new.flat_csum, new.ring)
    else:
        final = _with_rows(new, plan.new_cfg, plan.new_ring)
        dht_free(new)
    mig.new = final
    stats = {
        "n_live": plan.n_live,
        "n_planned": plan.n_moved,
        "moved": mig.moved,
        "skipped": mig.skipped,
        # resident entries displaced by migration inserts at near-full
        # destination windows: nonzero means the move lost entries (a
        # cache: a displaced entry becomes a miss, never an error)
        "evicted_at_dest": mig.evicted,
        "epoch": plan.new_ring.epoch,
        "inplace": int(plan.inplace),
    }
    return final, stats


def _run(mig: Migration) -> tuple[DHTState, dict[str, int]]:
    while not mig.done:
        mig, _ = migration_step(mig)
    return migration_finish(mig)


def _ring_of(state: DHTState, n_virtual: int = 64) -> RingState:
    if state.ring is not None:
        return state.ring
    # adopt: a ring over the current shard set (placement changes; the
    # migration relocates whatever the ring disagrees about)
    return ring_create(state.cfg.n_shards, n_virtual)


def dht_resize(state: DHTState, new_n_shards: int, *,
               buckets_per_shard: int | None = None,
               batch: int = DEFAULT_BATCH) -> tuple[DHTState, dict[str, int]]:
    """Grow or shrink the table to ``new_n_shards`` shards, online.  Every
    live entry survives (save those ``evicted_at_dest`` counts); with an
    unchanged bucket geometry only the owner-changed fraction moves."""
    new_ring = ring_resize(_ring_of(state), new_n_shards)
    new_cfg = dataclasses.replace(
        state.cfg, n_shards=new_n_shards,
        buckets_per_shard=buckets_per_shard or state.cfg.buckets_per_shard)
    return _run(migration_begin(state, new_ring, new_cfg, batch))


def adopt_ring(state: DHTState, n_virtual: int = 64,
               batch: int = DEFAULT_BATCH) -> tuple[DHTState, dict[str, int]]:
    """Migrate a modulo-placed table onto ring placement."""
    if state.ring is not None:
        raise ValueError("the table already has a ring")
    new_ring = ring_create(state.cfg.n_shards, n_virtual)
    return _run(migration_begin(state, new_ring, state.cfg, batch))


def shard_leave(state: DHTState, shard_id: int, *,
                batch: int = DEFAULT_BATCH) -> tuple[DHTState, dict[str, int]]:
    """Evacuate one shard and remove it from the ring (graceful leave or
    declared failure).  Its slab rows stay (cold); only its entries move."""
    ring = _ring_of(state)
    return _run(migration_begin(state, ring_leave(ring, shard_id),
                                state.cfg, batch))


def shard_join(state: DHTState, shard_id: int, *,
               batch: int = DEFAULT_BATCH) -> tuple[DHTState, dict[str, int]]:
    """Bring a shard that left back: it re-captures its vnode arcs and the
    entries there migrate in."""
    if state.ring is None:
        raise ValueError("shard_join needs a ring; call adopt_ring first")
    return _run(migration_begin(state, ring_join(state.ring, shard_id),
                                state.cfg, batch))


# ---------------------------------------------------------------------------
# anti-entropy repair
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RepairPlan:
    """The watermark diff: which surviving-replica entries the recovered
    shard is missing."""

    shard_id: int
    src: torch.Tensor     # (M,) int64 flat src bucket ids of the copies
    n_candidates: int     # deduped keys whose replica set holds shard_id
    n_present: int        # already there (re-written, or repaired before)

    @property
    def n_missing(self) -> int:
        return int(self.src.shape[0])


def hash_key64(h: torch.Tensor) -> torch.Tensor:
    """(n, 2) int32 ``hash64`` words -> (n,) int64 ``hi << 32 | lo``, one
    sortable word per key (a bijection of the pair)."""
    return (h[:, 0].to(torch.int64) << 32) | (h[:, 1].to(torch.int64)
                                              & MASK32)


def first_copies(h64: torch.Tensor, rows_of) -> torch.Tensor:
    """(M,) bool: which of M candidate copies, in flat order, is the
    first of its key, as ``np.unique(rows, axis=0, return_index=True)``
    picks them.  Keys are grouped by their 64-bit hash word ``h64`` (one
    stable sort); only the members of a group of two or more compare
    rows, ``rows_of(pos)`` handing over the key rows of the ascending
    positions ``pos``, so a hash collision never merges two keys.  Reads
    one count back to the host."""
    m = h64.shape[0]
    keep = torch.ones(m, dtype=torch.bool, device=h64.device)
    if m < 2:
        return keep
    order = torch.argsort(h64, stable=True)
    hs = h64[order]
    same = hs[1:] == hs[:-1]
    grouped = torch.zeros(m, dtype=torch.bool, device=h64.device)
    grouped[1:] |= same
    grouped[:-1] |= same
    member = torch.zeros_like(keep)
    member[order] = grouped
    pos = torch.nonzero(member).reshape(-1)
    if pos.shape[0] == 0:
        return keep
    # the members' exact classes: per distinct row, its first position
    _, inverse = torch.unique(rows_of(pos), dim=0, return_inverse=True)
    first = torch.full((pos.shape[0],), m, dtype=torch.int64,
                       device=pos.device)
    first.scatter_reduce_(0, inverse, pos, "amin")
    keep[pos] = first[inverse] == pos
    return keep


def window_present(state: DHTState, keys: torch.Tensor,
                   abs_base: torch.Tensor) -> torch.Tensor:
    """Which keys a live, key-equal bucket of the probe window at flat
    bucket ``abs_base`` holds already: one ``probe`` launch without
    checksum validation (a window never written is all zero and holds
    none)."""
    found, _sel, _val = _probe_window(state, abs_base, keys, validate=False)
    return found == 1


def plan_repair(state: DHTState, shard_id: int) -> RepairPlan:
    """Diff of the recovered shard against its replica peers, on the
    device.

    Enumerates the live entries on the *other* shards whose k-successor
    set holds ``shard_id`` (the copies the shard should hold), keeps one
    copy of each key (the first flat slot), and removes the keys already
    present in the shard's probe window.  ``src`` is in flat order, the
    reference's; two counts come back to the host."""
    cfg, ring = state.cfg, state.ring
    if ring is None:
        raise ValueError("repair needs a membership ring")
    if state.n_local != cfg.n_shards:
        raise ValueError("plan_repair needs the whole table (a rank's "
                         "shard repairs through ShardedDHT.repair)")
    flat = state.flat_keys[:-1]
    h = kops.hash64(flat.contiguous())
    succ = ring_successors(ring, h[:, 0], cfg.n_replicas)
    row = torch.arange(cfg.n_shards, dtype=torch.int32,
                       device=flat.device).repeat_interleave(
        cfg.buckets_per_shard)
    cand = (live_mask(state.meta).reshape(-1)
            & (succ == shard_id).any(dim=-1) & (row != shard_id))
    idx = torch.nonzero(cand).reshape(-1)
    idx = idx[first_copies(hash_key64(h[idx]),
                           lambda pos: flat[idx[pos]])]
    base = base_bucket(h[idx, 1], cfg.buckets_per_shard, cfg.n_probe)
    present = window_present(
        state, flat[idx],
        (base + shard_id * cfg.buckets_per_shard).to(torch.int32))
    n_candidates, n_present = torch.stack(
        [torch.full((), idx.shape[0], device=idx.device),
         present.sum()]).tolist()
    return RepairPlan(shard_id=shard_id, src=idx[~present],
                      n_candidates=n_candidates, n_present=n_present)


@dataclasses.dataclass
class Repair:
    """An in-flight anti-entropy pass for one recovered shard."""

    plan: RepairPlan
    state: DHTState
    batch: int = DEFAULT_BATCH
    cursor: int = 0
    healed: int = 0         # keys re-inserted at the recovered shard
    skipped: int = 0        # present after all (a racing write, a re-plan)
    rounds: int = 0

    @property
    def done(self) -> bool:
        return self.cursor >= self.plan.n_missing


def repair_begin(state: DHTState, shard_id: int,
                 batch: int = DEFAULT_BATCH) -> Repair:
    """Plan the diff and open a bounded repair stream.  The recovered
    shard must be live again (``faults.recover_shard``)."""
    if state.ring is None:
        raise ValueError("repair needs a membership ring")
    if not bool(state.ring.alive[shard_id]):
        raise ValueError("the repair target must be recovered (live) first")
    return Repair(plan=plan_repair(state, shard_id), state=state,
                  batch=batch)


def repair_round(state: DHTState, rows: torch.Tensor, valid: torch.Tensor,
                 shard_id: int, axis_name=None) -> torch.Tensor:
    """One get-or-put round of the copies in flat slots ``rows`` (those
    ``valid``), pinned to ``shard_id`` by ``placement`` (the replica
    select would send them to their live owners, which hold them
    already), at capacity 0 so the count-driven plan sizes the round to
    its one destination.  The table's buffers change in place.  Returns
    ``([dropped, healed, skipped], estats)``: the counts int64 on the
    device, and the round's stat lanes (under a process group, this
    rank's)."""
    keys, vals = state.flat_keys[rows], state.flat_vals[rows]
    step_st = DHTState(dataclasses.replace(state.cfg, capacity=0),
                       state.flat_keys, state.flat_vals, state.flat_meta,
                       state.flat_csum, state.ring)
    dest = torch.full((rows.shape[0],), shard_id, dtype=torch.int32,
                      device=rows.device)
    _, _, _vals, found, _code, es = dht_execute(
        step_st, migrate_ops(keys, vals, valid), kinds=("migrate",),
        axis_name=axis_name, placement=(dest, state.ring.epoch))
    return torch.stack([es["dropped"].to(torch.int64), (valid & ~found).sum(),
                        (valid & found).sum()]), es


def repair_step(rep: Repair) -> tuple[Repair, dict[str, int]]:
    """Heal one bounded batch in ONE get-or-put round pinned to the
    recovered shard (:func:`repair_round`).  Reads the round's counts
    back to the host once."""
    plan = rep.plan
    if rep.done:
        return rep, {"healed": 0, "skipped": 0, "remaining": 0}
    t0 = time.perf_counter()
    lo = rep.cursor
    hi = min(lo + rep.batch, plan.n_missing)
    n = hi - lo
    dev = plan.src.device
    pad = torch.zeros(rep.batch, dtype=torch.int64, device=dev)
    pad[:n] = plan.src[lo:hi]
    valid = torch.arange(rep.batch, device=dev) < n
    counts, _ = repair_round(rep.state, pad, valid, plan.shard_id)
    dropped, healed, skipped = counts.tolist()
    if dropped:
        raise RuntimeError(f"repair round dropped {dropped} rows")
    rep.cursor = hi
    rep.healed += healed
    rep.skipped += skipped
    rep.rounds += 1
    obs_metrics.inc("repair.rounds")
    obs_metrics.inc("repair.keys_healed", healed)
    step = {"healed": healed, "skipped": skipped,
            "remaining": plan.n_missing - rep.cursor}
    obs_trace.record_event("repair.step", step, t_start=t0,
                           ops={"migrate": n})
    return rep, step


def repair_diff(state: DHTState, shard_id: int) -> int:
    """Convergence check: how many replica copies the shard still lacks
    (0 after a completed repair)."""
    return plan_repair(state, shard_id).n_missing


def repair_run(state: DHTState, shard_id: int,
               batch: int = DEFAULT_BATCH) -> tuple[DHTState, dict[str, int]]:
    """Drive a full anti-entropy pass -> ``(state', stats)``; the table
    is healed in place."""
    rep = repair_begin(state, shard_id, batch)
    while not rep.done:
        rep, _ = repair_step(rep)
    return rep.state, {
        "n_candidates": rep.plan.n_candidates,
        "n_present": rep.plan.n_present,
        "n_planned": rep.plan.n_missing,
        "healed": rep.healed,
        "skipped": rep.skipped,
        "rounds": rep.rounds,
    }


__all__ = [
    "DEFAULT_BATCH", "Migration", "MigrationPlan", "Repair", "RepairPlan",
    "adopt_ring", "dht_resize", "migration_begin", "migration_finish",
    "migration_read", "migration_step", "plan_migration", "plan_repair",
    "repair_begin", "repair_diff", "repair_run", "repair_step",
    "shard_join", "shard_leave", "stale_sources",
]
