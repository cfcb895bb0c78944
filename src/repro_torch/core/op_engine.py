"""One-round op-engine for the DHT hot path (PyTorch port of
``repro.core.op_engine``: the synchronous, single-device subset).

Every operation is a request record (``OP_READ`` / ``OP_WRITE`` /
``OP_MIGRATE``, a key, and for the writing kinds a value);
:func:`dht_execute` runs an arbitrary mix in ONE routing round:

1. hash every key (``hash64`` kernel), owner shard ``hi % S`` (or the
   successor vnode on the state's consistent-hash ring), window base
   ``lo % (B - P + 1)``;
2. count-driven capacity and sort binning (``core/routing.py``);
3. one fused lane matrix packed into bins (``route_pack`` kernel);
4. one window pass over all virtual shards at once (the reference runs a
   ``vmap`` over the shards): the probing ops read the table as of round
   start through the ``probe`` kernel, checksum-failed buckets are
   flagged INVALID (lock-free mode), then the writes apply under the
   mode's schedule in bounded retry passes, each pass taking its slot
   decision from the ``shard_apply`` kernel and the new buckets'
   checksums from the ``checksum`` kernel;
5. the replies unpacked (``route_unpack`` kernel).

The three designs of the paper are the three modes: lock-free (readers
validate a checksum), fine-grained locking (writes to one window base
serialize into rounds) and coarse-grained locking (every write of a shard
takes its own round).  With ``l1_meta=True`` the replies also carry the
locality tier's coherence metadata (``core/l1cache.py``).

The slab is updated in place (see ``core/layout.py``).  Winner resolution
and slab updates are plain torch: ``scatter_reduce("amax")`` and index
writes, both aimed at the dump row where the reference drops an item.

Issue/commit split: :func:`dht_execute` is ``dht_commit(dht_issue(...))``.
:func:`dht_issue` enqueues the whole round, every read and write of the
slab included, on the current stream, records a CUDA event after its
last launch and returns an :class:`InFlightRound`.  :func:`dht_commit`
waits on that event alone (never on the whole device), resolves
pending-write forwards (``core/pipeline.py``) and returns the classic
tuple.  The stream's launch order stands in for the reference's
dataflow through the returned state: a round issued after another sees
its effects.

Multi-rank backend: with ``axis_name`` a ``torch.distributed`` process
group of S ranks, each rank holds one shard (``state.n_local == 1``)
and passes its own rows; both legs are ``all_to_all_single`` exchanges
(``core/routing.py``) and the rank's incoming rows, source-major, are
applied as its one shard.  Every rank issues the same collectives in
the same order: the values a branch depends on (the capacity, the
locked schedules' round count) are agreed by ``all_reduce(MAX)`` first.
The lock-free write passes make no collective, so ranks may take
different pass counts.  With ``elide_self``, the rows a rank owns skip
the exchange and ride the same shard pass as extra rows.

Dual-epoch rounds: with ``prev`` (the frozen previous-epoch table of an
in-flight migration, ``core/migrate.py``) each row carries an epoch
select lane ``esel`` and is routed by that epoch's owner and window
base; the shard side runs the ``probe`` kernel once over each epoch's
slab (the other epoch's rows get a harmless in-range base) and selects
by ``esel``.  Such a round is read-only; a checksum-failed bucket is
flagged INVALID in whichever slab it was read from.

k-successor replication (``cfg.n_replicas > 1`` on a ring): a round's
owner lookup is the crash-tolerant replica select
(:func:`replica_placement`): a key whose owner's liveness bit is down
goes to the first live shard of its successor set, read from the ring's
device twin of the liveness bits, and the rows so served are counted in
the ``fallback_reads`` lane.  Replicated writes fan out in
``dht.dht_write_replicated``.  An installed ``core.faults.FaultPlan``
drops rows of eligible single-device rounds before routing.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Sequence

import torch

from ..kernels import ops as kops
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from . import faults, routing
from .hashing import base_bucket, owner_shard, ring_owner
from .layout import (
    GEN_SHIFT,
    INVALID,
    MASK32,
    MODE_FINE,
    MODE_LOCKFREE,
    OCCUPIED,
    DHTConfig,
    DHTState,
    shard_watermark,
    to_i32,
    u32,
)
from .membership import ring_successors

# op tags
OP_READ = 0
OP_WRITE = 1
OP_MIGRATE = 2   # get-or-put: present -> return stored value, absent -> insert

# per-item result codes
W_DROPPED = 0   # routing overflow: not applied
W_INSERT = 1
W_UPDATE = 2
W_EVICT = 3     # window exhausted -> overwrote the last candidate
W_SKIP = 4      # OP_MIGRATE: key already present, nothing written

KINDS = ("read", "write", "migrate")

# keys of a round's packed telemetry lanes beside its stat lanes: the op
# counts of its mix, and the forwarded rows
_MIX, _FWD = "mix:", "forwarded:"


@dataclasses.dataclass
class OpBatch:
    """An op-tagged request batch.  ``op`` None means a uniform batch
    whose kind is given by ``dht_execute(..., kinds=)``.  ``esel`` picks
    the epoch a row probes (0 = ``state``, 1 = ``prev``) in a dual-epoch
    round."""

    keys: torch.Tensor                 # (n, KW) int32
    valid: torch.Tensor                # (n,) bool
    op: torch.Tensor | None = None     # (n,) int32 tag
    vals: torch.Tensor | None = None   # (n, VW) int32 write/migrate payload
    esel: torch.Tensor | None = None   # (n,) int32 epoch select


def _default_valid(keys: torch.Tensor, valid) -> torch.Tensor:
    if valid is None:
        return torch.ones(keys.shape[0], dtype=torch.bool, device=keys.device)
    return valid


def read_ops(keys, valid=None) -> OpBatch:
    """Uniform read batch (pair with ``kinds=("read",)``)."""
    return OpBatch(keys=keys, valid=_default_valid(keys, valid))


def write_ops(keys, vals, valid=None) -> OpBatch:
    """Uniform write batch (pair with ``kinds=("write",)``)."""
    return OpBatch(keys=keys, valid=_default_valid(keys, valid),
                   vals=vals.to(torch.int32))


def migrate_ops(keys, vals, valid=None) -> OpBatch:
    """Uniform get-or-put batch (pair with ``kinds=("migrate",)``)."""
    return OpBatch(keys=keys, valid=_default_valid(keys, valid),
                   vals=vals.to(torch.int32))


def mixed_ops(op, keys, vals, valid=None, esel=None) -> OpBatch:
    """Explicitly tagged mixed batch."""
    return OpBatch(keys=keys, valid=_default_valid(keys, valid),
                   op=op.to(torch.int32), vals=vals.to(torch.int32),
                   esel=None if esel is None else esel.to(torch.int32))


def dual_fusable(cfg: DHTConfig, prev_cfg: DHTConfig) -> bool:
    """Whether a dual-epoch probe can ride one round: the two epochs agree
    on the record geometry (word widths, probe window) and the previous
    shard set is addressable inside the current routing space (always
    true for in-place migrations, whose slab rows are the union of the
    two shard sets)."""
    return (prev_cfg.key_words == cfg.key_words
            and prev_cfg.val_words == cfg.val_words
            and prev_cfg.n_probe == cfg.n_probe
            and prev_cfg.n_shards <= cfg.n_shards)


# ---------------------------------------------------------------------------
# shard-side machinery, all virtual shards at once
# ---------------------------------------------------------------------------
# A slab here is the state's flat buffers: (S*B + 1, .) with the dump row
# last; windows are addressed by absolute base shard*B + base.

def _slab_views(state: DHTState):
    """The (S*B, .) slab without the dump row, as the kernel takes it."""
    return (state.flat_keys[:-1], state.flat_vals[:-1],
            state.flat_meta[:-1], state.flat_csum[:-1])


def _probe_window(state: DHTState, abs_base, keys,
                  validate: bool | None = None):
    """Read probe through the ``probe`` kernel: ``(found_tri, sel, val)``;
    ``found_tri`` is 1 (hit), -1 (selected bucket failed its checksum;
    lock-free mode only, the locking modes read without a checksum) or 0
    (no live key-equal candidate).  ``validate`` overrides the state's
    mode."""
    if validate is None:
        validate = state.cfg.mode == MODE_LOCKFREE
    val, found, rsel = kops.probe(
        *_slab_views(state), keys, abs_base, state.cfg.n_probe,
        validate_checksum=validate)
    return found, rsel, val


def _dual_probe(state: DHTState, prev: DHTState, base, shard, keys,
                in_prev):
    """The probe of a dual-epoch round: one ``probe`` launch over each
    epoch's flat slab, at that epoch's absolute bases (``shard * B +
    base``), the other epoch's rows aimed at bucket 0, then a select by
    ``in_prev``.  Both slabs validate by the new epoch's mode.  Returns
    ``(found_tri, val, slot_cur, slot_prev)``."""
    validate = state.cfg.mode == MODE_LOCKFREE
    b_cur = base + shard * state.cfg.buckets_per_shard
    b_prev = base + shard * prev.cfg.buckets_per_shard
    b_cur = torch.where(in_prev, 0, b_cur).to(torch.int32)
    b_prev = torch.where(in_prev, b_prev, 0).to(torch.int32)
    f_c, sel_c, val_c = _probe_window(state, b_cur, keys, validate)
    f_p, sel_p, val_p = _probe_window(prev, b_prev, keys, validate)
    found = torch.where(in_prev, f_p, f_c)
    val = torch.where(in_prev[:, None], val_p, val_c)
    return (found, val, (b_cur + sel_c).to(torch.int64),
            (b_prev + sel_p).to(torch.int64))


def _choose_write_slot(state: DHTState, abs_base, keys):
    """Paper §3.1 slot policy from the shard-apply kernel: ``(wsel, kind)``
    (same key -> W_UPDATE; first empty/INVALID -> W_INSERT; else the last
    candidate -> W_EVICT)."""
    _val, _found, _rsel, wsel, wkind = kops.shard_apply(
        *_slab_views(state), keys, abs_base, state.cfg.n_probe)
    return wsel, wkind


def _conflict_rank(group, valid, n_groups: int | None = None):
    """Rank of each valid item among items of the same conflict group,
    stable in item order: the sort-based rank that also bins routing
    destinations (``routing.stable_rank_by_group``)."""
    return routing.stable_rank_by_group(group, valid, n_groups=n_groups)


def _lock_token(group=None, n_shards: int = 1, device=None) -> int:
    """One acquire/release round trip's worth of traffic: 1 on the
    single-device backend.  Under a process group it is a real
    ``all_to_all`` of a (S, 1) ones tensor, one probe word to every
    shard, and counts the S words that come back (their sum is S by
    construction, so it is not read back to the host)."""
    if group is None:
        return 1
    import torch.distributed as dist

    probe = torch.ones((n_shards, 1), dtype=torch.int32, device=device)
    dist.all_to_all_single(torch.empty_like(probe), probe, group=group)
    return n_shards


def _write_pass(state: DHTState, abs_base, keys, vals, active):
    """One probe-and-publish pass.  Simultaneous writers on one bucket
    resolve deterministically: the highest item index wins.  Returns
    ``(kind, retry)``; the slab is updated in place."""
    dump = state.flat_meta.shape[0] - 1
    wsel, kind = _choose_write_slot(state, abs_base, keys)
    slot = (abs_base + wsel).to(torch.int64)
    iota = torch.arange(slot.shape[0], dtype=torch.int32, device=slot.device)

    prio = torch.where(active, iota, -1)
    winner = torch.full((dump + 1,), -1, dtype=torch.int32,
                        device=slot.device)
    winner.scatter_reduce_(0, torch.where(active, slot, dump), prio, "amax")
    is_winner = active & (winner[slot] == prio)
    wslot = torch.where(is_winner, slot, dump)

    old_gen = u32(state.flat_meta[slot]) >> GEN_SHIFT
    new_meta = to_i32((OCCUPIED | ((old_gen + 1) << GEN_SHIFT)) & MASK32)
    state.flat_keys[wslot] = keys
    state.flat_vals[wslot] = vals
    state.flat_meta[wslot] = new_meta
    state.flat_csum[wslot] = kops.checksum(keys, vals)

    # settled: the key now sits at its chosen slot (it won, or a same-key
    # duplicate with a higher index won); losers to another key re-probe
    same_key = (state.flat_keys[slot] == keys).all(dim=-1)
    retry = active & ~same_key & (kind != W_EVICT)
    return kind, retry


def _apply_writes(state: DHTState, abs_base, keys, vals, valid):
    """Bounded retry passes: concurrent inserts land on successive
    candidates.  Returns ``(code, n_passes)``: the most passes any shard
    took, which is what the reference's per-shard loops report as their
    max.  Reads one flag back to the host per pass."""
    active = valid
    code = torch.zeros(abs_base.shape, dtype=torch.int32,
                       device=abs_base.device)
    passes = 0
    while passes < state.cfg.n_probe and obs_trace.host_read(
            "write_flag", bool, active.any()):
        kind, retry = _write_pass(state, abs_base, keys, vals, active)
        code = torch.where(active, kind, code)
        active = retry
        passes += 1
    return code, passes


def _locked_write_rounds(state: DHTState, abs_base, keys, vals, valid,
                         group=None):
    """fine/coarse modes: serialize conflicting writes into rounds.  The
    conflict group is the absolute window base (fine: one lock per
    window) or the shard (coarse: one lock per shard); round ``r`` applies
    each group's ``r``-th write.  Every shard runs its own count of
    locked rounds, 2 lock tokens each, as under the reference's ``vmap``.
    Under a process group the rank's count is agreed with
    ``all_reduce(MAX)`` first, and every rank runs that many rounds, each
    with its lock-token exchange.  Returns ``(code, rounds, tokens)``:
    the most rounds any shard took and the tokens summed over this
    process's shards.  Reads the round counts back to the host once, and
    one flag per write pass."""
    cfg = state.cfg
    n_local = state.n_local
    shard = abs_base // cfg.buckets_per_shard
    if cfg.mode == MODE_FINE:
        group_id, n_groups = abs_base, n_local * cfg.buckets_per_shard
    else:
        group_id, n_groups = shard, n_local
    rank = _conflict_rank(group_id, valid, n_groups=n_groups)
    per_shard = torch.zeros(n_local, dtype=torch.int32, device=rank.device)
    per_shard.scatter_reduce_(0, shard.long(), torch.where(valid, rank + 1, 0),
                              "amax")
    if group is not None:
        import torch.distributed as dist

        agreed = per_shard.max().reshape(1)
        dist.all_reduce(agreed, op=dist.ReduceOp.MAX, group=group)
        n_rounds = obs_trace.host_read("lock_rounds", int, agreed)
    else:
        per_shard = obs_trace.host_read("lock_rounds", torch.Tensor.tolist,
                                        per_shard)
        n_rounds = max(per_shard)
    code = torch.zeros_like(rank)
    tokens = 0
    for r in range(n_rounds):
        mask = valid & (rank == r)
        wcode, _passes = _apply_writes(state, abs_base, keys, vals, mask)
        code = torch.where(mask, wcode, code)
        if group is not None:
            tokens += 2 * _lock_token(group, cfg.n_shards, rank.device)
    if group is None:
        tokens = 2 * _lock_token() * sum(per_shard)
    return code, n_rounds, tokens


def _shard_write(state: DHTState, abs_base, keys, vals, valid, group=None):
    """The mode's write schedule: ``(code, rounds, tokens)``."""
    if state.cfg.mode == MODE_LOCKFREE:
        code, passes = _apply_writes(state, abs_base, keys, vals, valid)
        return code, passes, 0
    return _locked_write_rounds(state, abs_base, keys, vals, valid, group)


def _validate_and_flag(state: DHTState, found_tri, slot, mask):
    """Lock-free mismatch policy (paper §4.2): a selected bucket whose
    checksum fails is flagged INVALID so writers may reclaim it.  Returns
    ``(found, n_mismatch)``."""
    dump = state.flat_meta.shape[0] - 1
    mismatch = mask & (found_tri == -1)
    mslot = torch.where(mismatch, slot, dump)
    state.flat_meta[mslot] = state.flat_meta[slot] | INVALID
    found = mask & (found_tri == 1)
    return found, mismatch.sum().to(torch.int32)


def _watermarks(state: DHTState) -> torch.Tensor:
    """Every shard's meta watermark, (S,) int32 bit-view words."""
    return to_i32(shard_watermark(state.meta))


def _shard_apply(state: DHTState, base, keys, vals, op, valid, kinds,
                 l1_meta: bool = False, group=None, prev=None, esel=None):
    """Apply every local shard's bins: probes see the round-start slab,
    writes follow under the mode's schedule.  ``base`` etc. are (S, cap,
    ...) bins, or (1, rows, ...) on a rank of the multi-rank backend
    (``group``: its lock tokens are exchanges).  With ``prev`` the rows
    whose ``esel`` is 1 probe the previous epoch's slab instead (the
    round is read-only).  Returns ``(val, found, code, n_mismatch,
    rounds, tokens, gen, wpre, wpost)`` shaped (S, cap, ...).  With
    ``l1_meta`` the last three are the coherence metadata: the
    round-start generation of each item's selected bucket (``meta >>
    GEN_SHIFT``) and every shard's watermark before and after the round's
    mutations, (S,); else None."""
    cfg = state.cfg
    s, cap = base.shape
    do_probe = ("read" in kinds) or ("migrate" in kinds)
    do_write = ("write" in kinds) or ("migrate" in kinds)
    locked = cfg.mode != MODE_LOCKFREE
    shard = torch.arange(s, dtype=torch.int32, device=base.device)
    abs_base = (base + shard[:, None] * cfg.buckets_per_shard).reshape(-1)
    keys = keys.reshape(s * cap, -1).contiguous()
    valid = valid.reshape(-1)
    if op is None:
        only = kinds[0]
        none = torch.zeros_like(valid)
        m_probe = valid if only != "write" else none
        m_migrate = valid if only == "migrate" else none
        m_write = valid if only == "write" else none
    else:
        op = op.reshape(-1)
        m_probe = valid & (op != OP_WRITE)
        m_migrate = valid & (op == OP_MIGRATE)
        m_write = valid & (op == OP_WRITE)

    c = s * cap
    wpre = _watermarks(state) if l1_meta else None
    val = torch.zeros((c, cfg.val_words), dtype=torch.int32,
                      device=base.device)
    found = torch.zeros(c, dtype=torch.bool, device=base.device)
    gen = (torch.zeros(c, dtype=torch.int32, device=base.device) if l1_meta
           else None)
    n_mm = torch.zeros((), dtype=torch.int32, device=base.device)
    tokens = 0
    if do_probe:
        if prev is None:
            found_tri, sel, pval = _probe_window(state, abs_base, keys)
            slot = (abs_base + sel).to(torch.int64)
            if l1_meta:   # the round-start snapshot, before any flagging
                gen = to_i32(u32(state.flat_meta[slot]) >> GEN_SHIFT)
        else:
            in_prev = esel.reshape(-1) == 1
            rows = shard[:, None].expand(s, cap).reshape(-1)
            found_tri, pval, slot, slot_p = _dual_probe(
                state, prev, base.reshape(-1), rows, keys, in_prev)
            if l1_meta:
                gen = to_i32(u32(torch.where(in_prev, prev.flat_meta[slot_p],
                                             state.flat_meta[slot]))
                             >> GEN_SHIFT)
        if locked:
            found = m_probe & (found_tri == 1)
            # shared-lock round trips
            tokens = 2 * _lock_token(group, cfg.n_shards, base.device) * s
        elif prev is None:
            found, n_mm = _validate_and_flag(state, found_tri, slot, m_probe)
        else:
            # flag a failed bucket in whichever epoch's slab was read
            found, n_mm = _validate_and_flag(state, found_tri, slot,
                                             m_probe & ~in_prev)
            found_p, mm_p = _validate_and_flag(prev, found_tri, slot_p,
                                               m_probe & in_prev)
            found, n_mm = found | found_p, n_mm + mm_p
        val = torch.where(found[:, None], pval, 0)

    code = torch.zeros(c, dtype=torch.int32, device=base.device)
    rounds = 0
    if do_write:
        wmask = m_write | (m_migrate & ~found)
        wvals = vals.reshape(c, -1).contiguous()
        with obs_trace.device_span("write"):
            wcode, rounds, tok_w = _shard_write(state, abs_base, keys,
                                                wvals, wmask, group)
        tokens += tok_w
        code = torch.where(wmask, wcode,
                           torch.where(m_migrate & found, W_SKIP, 0))
    if l1_meta:
        gen = gen.reshape(s, cap)
        wpost = _watermarks(state)
    else:
        wpost = None
    return (val.reshape(s, cap, -1), found.reshape(s, cap),
            code.to(torch.int32).reshape(s, cap), n_mm, rounds, tokens,
            gen, wpre, wpost)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def replica_placement(state: DHTState, h_hi):
    """Crash-tolerant placement under k-successor replication: each key
    goes to its owner unless the owner's liveness bit is down, then to
    the first live shard of its successor set (where every shard of the
    set is down, to the owner: the probe misses and the write drops, as
    at an unreachable rank).  Returns ``(dest, epoch, fallback)``,
    ``fallback`` marking the keys not served by their owner.  Needs a
    ring and ``cfg.n_replicas > 1``; reads the liveness bits from the
    ring's device twin, with no host copy."""
    r = state.ring.to(h_hi.device)
    succ = ring_successors(r, h_hi, state.cfg.n_replicas)   # (..., k)
    own = succ[..., 0]
    s = r.alive_dev.shape[0]
    ok = (succ >= 0) & r.alive_dev[succ.clamp(0, s - 1).long()]
    # argmax takes no bool; on ties it returns the first maximum
    col = torch.argmax(ok.to(torch.int32), dim=-1)
    dest = succ.gather(-1, col[..., None])[..., 0]
    dest = torch.where(ok.any(dim=-1), dest, own)
    return dest.to(torch.int32), r.epoch, dest != own


def _owner_epoch(state: DHTState, h_hi):
    """Owner placement and the membership epoch: the paper's static
    ``hash % S`` (epoch 0), or the state's consistent-hash ring (its
    successor vnode and its epoch, a Python int); under replication the
    crash-tolerant replica select (:func:`replica_placement`)."""
    r = state.ring
    if r is None:
        return owner_shard(h_hi, state.cfg.n_shards), 0
    if state.cfg.n_replicas > 1:
        dest, epoch, _fb = replica_placement(state, h_hi)
        return dest, epoch
    r = r.to(h_hi.device)
    return ring_owner(h_hi, r.positions, r.owners, r.n_live), r.epoch


def _route_ops(state: DHTState, ops: OpBatch, capacity: int | None,
               hashes=None, placement=None, bin_valid=None, group=None,
               prev=None):
    """Hash, place and bin the whole batch.  ``hashes`` takes a
    precomputed ``(hi, lo)`` pair and ``placement`` a precomputed ``(dest,
    epoch)``, so the L1 front end and the router share one ``hash64``
    launch.  ``bin_valid`` (default ``ops.valid``) leaves rows out of the
    binning and the capacity plan (self-elided rows).  Under a process
    ``group`` the capacity plan is agreed across ranks.  With ``prev``
    the rows whose ``ops.esel`` is 1 go to their owner and window base
    under the previous epoch.  Returns ``(binned, base, used_prologue)``."""
    cfg = state.cfg
    if hashes is None:
        h = kops.hash64(ops.keys.contiguous())
        hashes = (h[:, 0], h[:, 1])
    dest, epoch = (_owner_epoch(state, hashes[0]) if placement is None
                   else placement)
    base = base_bucket(hashes[1], cfg.buckets_per_shard, cfg.n_probe)
    if prev is not None:
        in_prev = ops.esel == 1
        dest = torch.where(in_prev, _owner_epoch(prev, hashes[0])[0], dest)
        base = torch.where(in_prev, base_bucket(
            hashes[1], prev.cfg.buckets_per_shard, prev.cfg.n_probe), base)
    bin_valid = ops.valid if bin_valid is None else bin_valid
    cap = capacity or cfg.capacity
    used_prologue = not cap
    if used_prologue:
        cap = routing.plan_capacity(dest, cfg.n_shards, valid=bin_valid,
                                    group=group)
    binned = routing.bin_by_dest(dest, cfg.n_shards, cap, epoch=epoch,
                                 valid=bin_valid)
    return binned, base, used_prologue


def _check_supported(state: DHTState, kinds, ops: OpBatch, prev=None,
                     placement=None, pending=None, axis_name=None) -> None:
    if not kinds or any(k not in KINDS for k in kinds):
        raise ValueError(f"kinds must be a non-empty subset of {KINDS}")
    if prev is None:
        return
    if ops.esel is None:
        raise ValueError("a dual-epoch round needs ops.esel")
    if kinds != ("read",) or ops.op is not None:
        # an esel == 1 write would be routed by the old placement but
        # applied to the new slab, where nothing could find it
        raise ValueError("a dual-epoch round is read-only; writes go "
                         "through a single-epoch round of the new epoch")
    if not dual_fusable(state.cfg, prev.cfg):
        raise ValueError("the epochs' geometries cannot share one round: "
                         "use the sequential dual read")
    if placement is not None or pending is not None:
        raise ValueError("a dual-epoch round takes no precomputed "
                         "placement and no pending-write filter")
    if axis_name is not None:
        raise ValueError("dual-epoch rounds run on the single-device "
                         "backend")
    if prev.n_local != prev.cfg.n_shards:
        raise ValueError("prev must hold its whole table")


def _rank_group(state: DHTState, axis_name):
    """The round's process group (None on the single-device backend),
    checked against the state: one shard a rank, S ranks."""
    group = routing.process_group(axis_name, state.device)
    if group is None:
        if state.n_local != state.cfg.n_shards:
            raise ValueError(
                f"this state holds {state.n_local} of {state.cfg.n_shards} "
                "shards: a rank's shard takes its process group "
                "(axis_name)")
        return None
    import torch.distributed as dist

    world = dist.get_world_size(group)
    if world != state.cfg.n_shards or state.n_local != 1:
        raise ValueError(
            f"the multi-rank backend holds one shard a rank: n_shards="
            f"{state.cfg.n_shards}, world size {world}, this state holds "
            f"{state.n_local} shards")
    return group


@dataclasses.dataclass
class InFlightRound:
    """An issued-but-uncommitted engine round: the handle
    :func:`dht_commit` takes.

    ``state`` is the round's table (the input state, updated in place by
    work already on the stream); the next round may be issued against it
    at once.  ``event`` is recorded after the round's last launch (None
    on the CPU, where the round has finished when issue returns).
    ``conflict``/``pending``/``keys`` carry the pending-write hazard:
    rows masked out of the probe at issue because a promised write to
    their key was not issued yet, resolved at commit from the pending
    table's published values.  ``telemetry`` is filled at commit:
    ``issue_us``, ``hidden_us`` (host time between issue returning and
    commit being called), ``commit_wait_us`` and ``overlap_frac`` (hidden
    over the round's whole duration).  ``meta`` is free-form wrapper
    state.  ``prev`` is a dual-epoch round's previous-epoch table (None
    otherwise).

    The round's self-record, set only when recording is on and the round
    has no process group: ``mix`` counts its requests per kind (0-d
    tensors), forwarded rows included; ``source`` names its trace event;
    ``marks`` are its phase marks; ``lanes`` holds its scalar stat lanes
    and mix counts on their way to the host (``obs.trace._HostLanes``);
    ``spans`` its device spans and timed host reads
    (``obs.trace.RoundSpans``: on the card, or while a profiler collects).
    """

    state: DHTState
    vals: torch.Tensor
    found: torch.Tensor
    code: torch.Tensor
    estats: dict[str, Any]
    mix: dict[str, torch.Tensor] | None
    t_start: float
    t_issued: float
    event: Any = None
    pending: Any = None
    conflict: torch.Tensor | None = None
    keys: torch.Tensor | None = None
    committed: bool = False
    telemetry: dict[str, float] = dataclasses.field(default_factory=dict)
    meta: dict = dataclasses.field(default_factory=dict)
    prev: DHTState | None = None
    source: str = ""
    marks: list = dataclasses.field(default_factory=list)
    lanes: Any = None
    spans: Any = None


def dht_issue(state: DHTState, ops: OpBatch, *,
              kinds: Sequence[str] = KINDS, capacity: int | None = None,
              prev=None, axis_name=None, hashes=None, placement=None,
              l1_meta: bool = False, elide_self=None,
              pending=None) -> InFlightRound:
    """Issue an op-tagged request batch as ONE routing round and return
    without waiting for its results: the issue half of the engine.

    ``hashes`` / ``placement`` take a precomputed ``(hi, lo)`` hash pair
    and ``(dest, epoch)``.  ``prev`` (the previous-epoch table of an
    in-flight migration, single-device backend) makes a dual-epoch read
    round: ``ops.esel`` says which epoch each row probes.  ``l1_meta=True`` piggybacks the locality
    tier's coherence metadata on the reply lanes: ``estats`` gains
    ``bucket_gen`` (per item, the round-start generation of its serving
    bucket) and ``wmark_pre``/``wmark_post`` ((S,) shard watermarks
    before and after the round), as int32 bit-views; 3 reply lanes, no
    extra round.

    ``pending`` (a ``core.pipeline.PendingWrites``, uniform read rounds
    only): rows whose key has a promised-but-unissued write are masked
    out of the probe (no bin slot, no wire), still count in the round's
    ``mix``, and are served at commit by forwarding the published value.

    Telemetry: unless recording is off (``obs.metrics``) or the round
    runs under a process group (whose wrapper records the group's
    lanes), the round records itself at commit as one trace event named
    ``"engine." + "+".join(kinds)`` with its
    ``bin``/``dispatch``/``apply``/``collect``/``commit`` phase spans
    (``OBS_FENCE=1`` fences each mark with ``torch.cuda.synchronize``).
    The issue half then packs the round's scalar lanes and op counts into
    one tensor and copies it to pinned host memory without waiting, so
    the commit half reads them after the round's event with no host sync
    of its own.  On the card the round also carries device spans: a
    timing event at each phase mark and around the write schedule, read
    at commit into the lanes ``device_us.<span>``, and every host read of
    a device value below is timed (``obs.trace.host_read``); while a
    ``torch.profiler`` collects, the phases are its ranges
    ``engine.<phase>``.

    ``axis_name``: a ``torch.distributed`` process group of
    ``cfg.n_shards`` ranks; ``state`` is this rank's one shard
    (``dht_create(..., shards=1)``) and ``ops`` its own rows.  The stat
    lanes are this rank's; ``core/distributed.py`` reduces them.
    ``elide_self``: rows this rank owns skip the exchange (no bin slot,
    no wire words) and are probed in the same shard pass; the result is
    bit for bit the routed one.  Default (None): on for every uniform
    read round under a group, off otherwise; asking for it elsewhere
    raises ``ValueError``.

    Every slab access of the round is enqueued here, in stream order, so
    a read issued before a write never sees it, and one issued after
    does.  The host still waits inside this half where the round's
    shape needs a device value: the capacity plan reads the largest bin
    (``routing.plan_capacity``), every write pass reads whether a row is
    still active, the locked schedules read each shard's round count,
    and the ``pending`` filter reads the size of its row match.  Under a
    group the capacity and the round count are agreed across ranks
    before they are read.

    The reference may issue two rounds against one input state and get
    two branches; the port's table is one buffer, so a second round
    issued against the same state sees the first's effects.  Between
    two reads those are at most INVALID flags of torn buckets, which a
    synchronous run never has.

    Returns an :class:`InFlightRound` for :func:`dht_commit`.  Commit
    rounds in issue order when a ``pending`` filter is in play."""
    t_start = time.perf_counter()
    kinds = tuple(kinds)
    _check_supported(state, kinds, ops, prev, placement, pending, axis_name)
    group = _rank_group(state, axis_name)
    rec = obs_metrics.enabled() and group is None
    spans = obs_trace.begin_round(ops.keys.device) if rec else None
    try:
        return _issue(state, ops, kinds, capacity=capacity, prev=prev,
                      group=group, hashes=hashes, placement=placement,
                      l1_meta=l1_meta, elide_self=elide_self,
                      pending=pending, t_start=t_start, rec=rec,
                      spans=spans)
    finally:
        if spans is not None:
            spans.close()


def _issue(state: DHTState, ops: OpBatch, kinds: tuple, *, capacity, prev,
           group, hashes, placement, l1_meta, elide_self, pending,
           t_start, rec, spans) -> InFlightRound:
    """The issue half of :func:`dht_issue`, whose caller closes the
    round's spans however it ends."""
    cfg = state.cfg
    do_write = ("write" in kinds) or ("migrate" in kinds)
    if do_write and ops.vals is None:
        raise ValueError("write/migrate batches need a value lane")
    if ops.op is None and len(kinds) != 1:
        raise ValueError("untagged batches must be uniform-kind")
    # deterministic fault injection (core/faults.py): dropped rows come
    # back W_DROPPED / not found, like a routing overflow.  Single-device
    # rounds only, as in the reference, whose traced sharded rounds never
    # see the plan; with none installed nothing here touches the card
    fplan = faults.get_plan()
    if fplan is not None and group is None:
        ops = fplan.perturb(ops, kinds)
    conflict = None
    if pending is not None:
        if kinds != ("read",) or ops.op is not None:
            raise ValueError(
                "pending-write filtering applies to uniform read rounds")
        if len(pending):
            conflict = pending.conflicts(ops.keys, ops.valid)
            ops = OpBatch(keys=ops.keys, valid=ops.valid & ~conflict)
    # replica-select lane: under replication the round's placement is the
    # first live replica, and the rows not served by their owner are
    # counted.  Callers that pass ``placement`` (the L1 front end, the
    # replicated write fan-out, repair) do their own accounting.
    n_fallback = 0
    if (cfg.n_replicas > 1 and state.ring is not None
            and placement is None and prev is None):
        if hashes is None:
            h = kops.hash64(ops.keys.contiguous())
            hashes = (h[:, 0], h[:, 1])
        dest_r, epoch_r, fb = replica_placement(state, hashes[0])
        placement = (dest_r, epoch_r)
        n_fallback = (ops.valid & fb).sum().to(torch.int32)
    elidable = group is not None and kinds == ("read",) and ops.op is None
    elide = elidable if elide_self is None else bool(elide_self)
    if elide and not elidable:
        raise ValueError(
            "self-traffic elision needs a uniform read round on the "
            "multi-rank backend (axis_name a process group)")
    is_self, bin_valid = None, ops.valid
    if elide:
        if hashes is None:
            h = kops.hash64(ops.keys.contiguous())
            hashes = (h[:, 0], h[:, 1])
        if placement is None:
            placement = _owner_epoch(state, hashes[0])
        import torch.distributed as dist

        is_self = ops.valid & (placement[0] == dist.get_rank(group))
        bin_valid = ops.valid & ~is_self

    binned, base, used_prologue = _route_ops(state, ops, capacity, hashes,
                                             placement, bin_valid, group,
                                             prev)
    payloads = [base, ops.keys]
    if do_write:
        payloads.append(ops.vals.to(torch.int32))
    if ops.op is not None:
        payloads.append(ops.op.to(torch.int32))
    if prev is not None:
        payloads.append(ops.esel.to(torch.int32))
    payloads.append((ops.valid & binned.kept).to(torch.int32))
    if rec:
        # OBS_FENCE=1: wait for each phase's products before the next
        # mark, so the spans measure device time, not issue time
        obs_trace.fence(binned.pos, binned.kept, payloads)
    t_dispatch = time.perf_counter()
    if spans is not None:
        spans.phase("dispatch")
    inc = routing.dispatch(binned, payloads, group)
    if rec:
        obs_trace.fence(inc)
    t_apply = time.perf_counter()
    if spans is not None:
        spans.phase("apply")

    it = iter(inc)
    b_in, k_in = next(it), next(it)
    v_in = next(it) if do_write else None
    o_in = next(it) if ops.op is not None else None
    e_in = next(it) if prev is not None else None
    m_in = next(it)
    if group is not None:
        if elide:
            # self-owned rows ride the same shard pass as extra rows
            # after the incoming buffer: one probe, no exchange
            b_in = torch.cat([b_in, base])
            k_in = torch.cat([k_in, ops.keys])
            m_in = torch.cat([m_in, is_self.to(torch.int32)])
        # the rank's rows are its one shard's bin
        b_in, k_in, m_in = b_in[None], k_in[None], m_in[None]
        v_in = None if v_in is None else v_in[None]
        o_in = None if o_in is None else o_in[None]
    (val, found, code, n_mm, rounds, tokens,
     gen, wpre, wpost) = _shard_apply(state, b_in, k_in, v_in, o_in,
                                      m_in.to(torch.bool), kinds, l1_meta,
                                      group, prev, e_in)
    if rec:
        obs_trace.fence(val, found, code)
    t_collect = time.perf_counter()
    if spans is not None:
        spans.phase("collect")
    local = None
    if group is not None:
        val, found, code = val[0], found[0], code[0]
        gen = None if gen is None else gen[0]
        if elide:
            rows = binned.n_dest * binned.capacity
            local = (val[rows:], found[rows:], code[rows:],
                     None if gen is None else gen[rows:])
            val, found, code = val[:rows], found[:rows], code[:rows]
            gen = None if gen is None else gen[:rows]
    replies = [val, found.to(torch.int32), code]
    if l1_meta:
        # each shard's watermarks fill every row of its reply block, so
        # row 0 of the block carries them (routing.collect block_rows)
        shape = gen.shape
        if group is None:
            wpre, wpost = wpre[:, None], wpost[:, None]
        replies += [gen, wpre.expand(shape), wpost.expand(shape)]
        items, blocks = routing.collect(binned, replies, group,
                                        block_rows=True)
    else:
        items = routing.collect(binned, replies, group)
    val_b, found_b, code_b = items[:3]
    gen_out = items[3] if l1_meta else None

    live = ops.valid & binned.kept
    found_out = (found_b > 0) & live
    code_out = torch.where(live, code_b, W_DROPPED)
    if local is not None:
        val_l, found_l, code_l, gen_l = local
        found_out = torch.where(is_self, found_l, found_out)
        val_b = torch.where(is_self[:, None], val_l, val_b)
        code_out = torch.where(is_self, code_l, code_out)
        if l1_meta:
            gen_out = torch.where(is_self, gen_l, gen_out)
    val_out = torch.where(found_out[:, None], val_b, 0)
    # the elided self block is padding that never crosses the fabric
    wire = routing.wire_stats(
        binned, routing.lane_width(payloads),
        cfg.val_words + 2 + (3 if l1_meta else 0),
        prologue_words=2 * cfg.n_shards if used_prologue else 0,
        n_self_rows=binned.capacity if elide else 0)
    bcounts = routing.bin_counts(binned)
    btotal = torch.clamp(bcounts.sum(), min=1).to(torch.float32)
    bmax = bcounts.max().to(torch.float32)
    estats = {
        "mismatches": n_mm,
        "rounds": rounds,
        "lock_tokens": tokens,
        "dropped": binned.n_dropped,
        "epoch": binned.epoch,
        "wire_words": wire["wire_words"],
        "wire_send_words": wire["wire_send_words"],
        "wire_reply_words": wire["wire_reply_words"],
        "fill_frac": wire["fill_frac"],
        "dispatch_rounds": 1,
        "n_shards": cfg.n_shards,
        "capacity": binned.capacity,
        "bin_counts": bcounts,
        "bin_max_load": bcounts.max(),
        "bin_imbalance": bmax * float(cfg.n_shards) / btotal,
        "hot_frac": bmax / btotal,
        "fallback_reads": n_fallback,
    }
    if l1_meta:
        estats["bucket_gen"] = gen_out
        estats["wmark_pre"] = blocks[4]
        estats["wmark_post"] = blocks[5]
    mix = lanes = None
    marks = []
    if rec:
        if ops.op is None:
            mix = {kinds[0]: ops.valid.sum()}
        else:
            mix = {name: (ops.valid & (ops.op == tag)).sum()
                   for name, tag in (("read", OP_READ), ("write", OP_WRITE),
                                     ("migrate", OP_MIGRATE))
                   if name in kinds}
        packed = dict(estats)
        packed.update((_MIX + k, v) for k, v in mix.items())
        if conflict is not None:
            # forwarded rows left the probe but are still this round's
            # traffic
            n_fwd = conflict.sum()
            mix["read"] = mix["read"] + n_fwd
            packed[_MIX + "read"] = mix["read"]
            packed[_FWD] = n_fwd
        # on the card: copied to pinned memory ahead of the round's event
        lanes = obs_trace._HostLanes(packed, pin=True)
        marks = [("bin", t_start), ("dispatch", t_dispatch),
                 ("apply", t_apply), ("collect", t_collect)]
    event = None
    if val_out.is_cuda:
        # the round's own event ends its last device span
        event = torch.cuda.Event(enable_timing=spans is not None)
        event.record(None if spans is None else spans.stream)
    forwards = conflict is not None
    return InFlightRound(
        state=state, vals=val_out, found=found_out, code=code_out,
        estats=estats, mix=mix, t_start=t_start,
        t_issued=time.perf_counter(), event=event,
        pending=pending if forwards else None, conflict=conflict,
        keys=ops.keys if forwards else None, prev=prev,
        source="engine." + "+".join(kinds), marks=marks,
        lanes=lanes, spans=spans)


def dht_commit(rnd: InFlightRound):
    """Wait for an issued round's results: the commit half.

    Waits on the round's own event, so work queued after the round
    (later rounds, the caller's compute) keeps running; in a round on
    the card that records itself the wait is timed (site ``commit``) and
    the round's device spans are read after it, with no sync of their
    own.  Resolves
    pending-write forwards: conflicted rows get the published value and
    ``found=True``, bit for bit what a read after the write round would
    have returned; a conflicted key never published raises.  Fills
    ``rnd.telemetry`` and, for a round that records itself, flushes its
    lanes (read from the host copy the issue half made) with a
    ``commit`` span and the four telemetry lanes into the registry and
    the trace (``obs.trace.record_round``).

    Returns the reference's tuple ``(state', prev', vals, found, code,
    estats)``; ``state'`` is the input state updated in place, ``prev'``
    the dual-epoch round's previous-epoch table (None otherwise; only
    INVALID flags ever change it).  ``estats`` has the reference's keys; values derived from the
    data are 0-d tensors on the state's device, static geometry and the
    host-side counts (``rounds``, ``lock_tokens``) are int."""
    if rnd.committed:
        raise RuntimeError("InFlightRound committed twice")
    rnd.committed = True
    vals, found = rnd.vals, rnd.found
    if rnd.conflict is not None:
        fvals = rnd.pending.resolve(rnd.keys, rnd.conflict)
        vals = torch.where(rnd.conflict[:, None], fvals, vals)
        found = found | rnd.conflict
    t_commit = time.perf_counter()
    spans = rnd.spans
    if spans is not None:
        spans.commit()
    if rnd.event is not None:
        obs_trace.host_read("commit", torch.cuda.Event.synchronize,
                            rnd.event, spans)
    now = time.perf_counter()
    dur = max(now - rnd.t_start, 0.0)
    hidden = max(t_commit - rnd.t_issued, 0.0)
    rnd.telemetry = {
        "issue_us": (rnd.t_issued - rnd.t_start) * 1e6,
        "hidden_us": hidden * 1e6,
        "commit_wait_us": max(now - t_commit, 0.0) * 1e6,
        "overlap_frac": min(hidden / dur, 1.0) if dur > 0 else 0.0,
    }
    if rnd.lanes is not None:
        lanes = rnd.lanes.get()
        stats = {k: v for k, v in lanes.items() if not k.startswith(_MIX)
                 and k != _FWD}
        stats.update(rnd.telemetry)
        if lanes.get(_FWD):
            stats["forwarded"] = lanes[_FWD]
        if spans is not None:
            stats.update(spans.lanes(rnd.event))
        obs_trace.record_round(
            rnd.source, stats,
            ops={k[len(_MIX):]: v for k, v in lanes.items()
                 if k.startswith(_MIX)},
            t_start=rnd.t_start, phase_marks=rnd.marks + [("commit",
                                                           t_commit)])
    if spans is not None:
        spans.close()
    return rnd.state, rnd.prev, vals, found, rnd.code, rnd.estats


def dht_execute(state: DHTState, ops: OpBatch, *,
                kinds: Sequence[str] = KINDS, capacity: int | None = None,
                prev=None, axis_name=None, hashes=None, placement=None,
                l1_meta: bool = False, elide_self=None):
    """Execute an op-tagged request batch in ONE routing round,
    synchronously: ``dht_commit(dht_issue(...))``.  See
    :func:`dht_issue` for the keywords and :func:`dht_commit` for the
    returned tuple."""
    return dht_commit(dht_issue(
        state, ops, kinds=kinds, capacity=capacity, prev=prev,
        axis_name=axis_name, hashes=hashes, placement=placement,
        l1_meta=l1_meta, elide_self=elide_self))


__all__ = [
    "KINDS", "InFlightRound", "OP_MIGRATE", "OP_READ", "OP_WRITE",
    "OpBatch", "W_DROPPED", "W_EVICT", "W_INSERT", "W_SKIP", "W_UPDATE",
    "dht_commit", "dht_execute", "dht_issue", "dual_fusable", "migrate_ops",
    "mixed_ops", "read_ops", "replica_placement", "write_ops",
]
