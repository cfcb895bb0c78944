"""One-round op-engine for the DHT hot path (PyTorch port of
``repro.core.op_engine``: the lock-free, synchronous, single-device subset).

Every operation is a request record (``OP_READ`` / ``OP_WRITE`` /
``OP_MIGRATE``, a key, and for the writing kinds a value);
:func:`dht_execute` runs an arbitrary mix in ONE routing round:

1. hash every key (``hash64`` kernel), owner shard ``hi % S``, window base
   ``lo % (B - P + 1)``;
2. count-driven capacity and sort binning (``core/routing.py``);
3. one fused lane matrix packed into bins (``route_pack`` kernel);
4. one window pass over all virtual shards at once (``shard_apply``
   kernel; the reference runs a ``vmap`` over the shards): the probing
   ops read the table as of round start, checksum-failed buckets are
   flagged INVALID, then the writes apply in bounded retry passes, each
   pass taking its slot decision from the same kernel and the new
   buckets' checksums from the ``checksum`` kernel;
5. the replies unpacked (``route_unpack`` kernel).

The slab is updated in place (see ``core/layout.py``).  Winner resolution
and slab updates are plain torch: ``scatter_reduce("amax")`` and index
writes, both aimed at the dump row where the reference drops an item.

Not in this slice (each raises ``NotImplementedError`` naming its ROADMAP
item): the fine/coarse schedules, dual-epoch ``prev``, the ring, the L1
metadata piggyback, precomputed ``hashes``/``placement``, ``pending``
forwarding and the issue/commit split.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..kernels import ops as kops
from ..obs import metrics as obs_metrics
from . import routing
from .hashing import base_bucket, owner_shard
from .layout import (
    GEN_SHIFT,
    INVALID,
    MASK32,
    MODE_LOCKFREE,
    OCCUPIED,
    DHTState,
    to_i32,
    u32,
)

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


@dataclasses.dataclass
class OpBatch:
    """An op-tagged request batch.  ``op`` None means a uniform batch
    whose kind is given by ``dht_execute(..., kinds=)``."""

    keys: torch.Tensor                 # (n, KW) int32
    valid: torch.Tensor                # (n,) bool
    op: torch.Tensor | None = None     # (n,) int32 tag
    vals: torch.Tensor | None = None   # (n, VW) int32 write/migrate payload


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
    if esel is not None:
        raise routing.not_ported("dual-epoch batches (esel)", "11")
    return OpBatch(keys=keys, valid=_default_valid(keys, valid),
                   op=op.to(torch.int32), vals=vals.to(torch.int32))


# ---------------------------------------------------------------------------
# shard-side machinery, all virtual shards at once
# ---------------------------------------------------------------------------
# A slab here is the state's flat buffers: (S*B + 1, .) with the dump row
# last; windows are addressed by absolute base shard*B + base.

def _slab_views(state: DHTState):
    """The (S*B, .) slab without the dump row, as the kernel takes it."""
    return (state.flat_keys[:-1], state.flat_vals[:-1],
            state.flat_meta[:-1], state.flat_csum[:-1])


def _probe_window(state: DHTState, abs_base, keys):
    """Read probe: ``(found_tri, sel, val)`` from the shard-apply kernel;
    ``found_tri`` is 1 (checksum-valid hit), -1 (selected bucket failed its
    checksum) or 0 (no live key-equal candidate)."""
    val, found, rsel, _wsel, _wkind = kops.shard_apply(
        *_slab_views(state), keys, abs_base, state.cfg.n_probe)
    return found, rsel, val


def _choose_write_slot(state: DHTState, abs_base, keys):
    """Paper §3.1 slot policy from the shard-apply kernel: ``(wsel, kind)``
    (same key -> W_UPDATE; first empty/INVALID -> W_INSERT; else the last
    candidate -> W_EVICT)."""
    _val, _found, _rsel, wsel, wkind = kops.shard_apply(
        *_slab_views(state), keys, abs_base, state.cfg.n_probe)
    return wsel, wkind


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
    while passes < state.cfg.n_probe and bool(active.any()):
        kind, retry = _write_pass(state, abs_base, keys, vals, active)
        code = torch.where(active, kind, code)
        active = retry
        passes += 1
    return code, passes


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


def _shard_apply(state: DHTState, base, keys, vals, op, valid, kinds):
    """Apply every virtual shard's bins: probes see the round-start slab,
    writes follow.  ``base`` etc. are (S, cap, ...) bins.  Returns
    ``(val, found, code, n_mismatch, passes)`` shaped (S, cap, ...)."""
    cfg = state.cfg
    s, cap = base.shape
    do_probe = ("read" in kinds) or ("migrate" in kinds)
    do_write = ("write" in kinds) or ("migrate" in kinds)
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
    val = torch.zeros((c, cfg.val_words), dtype=torch.int32,
                      device=base.device)
    found = torch.zeros(c, dtype=torch.bool, device=base.device)
    n_mm = torch.zeros((), dtype=torch.int32, device=base.device)
    if do_probe:
        found_tri, sel, pval = _probe_window(state, abs_base, keys)
        slot = (abs_base + sel).to(torch.int64)
        found, n_mm = _validate_and_flag(state, found_tri, slot, m_probe)
        val = torch.where(found[:, None], pval, 0)

    code = torch.zeros(c, dtype=torch.int32, device=base.device)
    passes = 0
    if do_write:
        wmask = m_write | (m_migrate & ~found)
        wvals = vals.reshape(c, -1).contiguous()
        wcode, passes = _apply_writes(state, abs_base, keys, wvals, wmask)
        code = torch.where(wmask, wcode,
                           torch.where(m_migrate & found, W_SKIP, 0))
    return (val.reshape(s, cap, -1), found.reshape(s, cap),
            code.to(torch.int32).reshape(s, cap), n_mm, passes)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _owner_epoch(state: DHTState, h_hi):
    """Owner placement: the paper's static ``hash % S`` (epoch 0).  The
    consistent-hash ring and replica select are later slices."""
    return owner_shard(h_hi, state.cfg.n_shards), 0


def _route_ops(state: DHTState, ops: OpBatch, capacity: int | None):
    """Hash, place and bin the whole batch.  Returns ``(binned, base,
    used_prologue)``."""
    cfg = state.cfg
    h = kops.hash64(ops.keys.contiguous())
    dest, epoch = _owner_epoch(state, h[:, 0])
    base = base_bucket(h[:, 1], cfg.buckets_per_shard, cfg.n_probe)
    cap = capacity or cfg.capacity
    used_prologue = not cap
    if used_prologue:
        cap = routing.plan_capacity(dest, cfg.n_shards, valid=ops.valid)
    binned = routing.bin_by_dest(dest, cfg.n_shards, cap, epoch=epoch,
                                 valid=ops.valid)
    return binned, base, used_prologue


def _check_supported(state: DHTState, kinds, **later) -> None:
    cfg = state.cfg
    if cfg.mode != MODE_LOCKFREE:
        raise routing.not_ported(f"the {cfg.mode!r} locking schedule", "6")
    if cfg.n_replicas > 1:
        raise routing.not_ported("k-successor replication", "12")
    items = {"prev": "11", "axis_name": "7", "hashes": "9",
             "placement": "9", "l1_meta": "9", "elide_self": "9",
             "pending": "10"}
    for name, value in later.items():
        if value not in (None, False):
            raise routing.not_ported(f"dht_execute({name}=...)", items[name])
    if not kinds or any(k not in KINDS for k in kinds):
        raise ValueError(f"kinds must be a non-empty subset of {KINDS}")


def dht_execute(state: DHTState, ops: OpBatch, *,
                kinds: Sequence[str] = KINDS, capacity: int | None = None,
                prev=None, axis_name=None, hashes=None, placement=None,
                l1_meta: bool = False, elide_self=None, pending=None):
    """Execute an op-tagged request batch in ONE routing round.

    Returns the reference's tuple ``(state', prev', vals, found, code,
    estats)``; ``state'`` is ``state`` updated in place and ``prev'`` is
    None.  ``estats`` has the reference's keys; values derived from the
    data are 0-d tensors on the state's device, static geometry is int."""
    kinds = tuple(kinds)
    _check_supported(state, kinds, prev=prev, axis_name=axis_name,
                     hashes=hashes, placement=placement, l1_meta=l1_meta,
                     elide_self=elide_self, pending=pending)
    cfg = state.cfg
    do_write = ("write" in kinds) or ("migrate" in kinds)
    if do_write and ops.vals is None:
        raise ValueError("write/migrate batches need a value lane")
    if ops.op is None and len(kinds) != 1:
        raise ValueError("untagged batches must be uniform-kind")

    binned, base, used_prologue = _route_ops(state, ops, capacity)
    payloads = [base, ops.keys]
    if do_write:
        payloads.append(ops.vals.to(torch.int32))
    if ops.op is not None:
        payloads.append(ops.op.to(torch.int32))
    payloads.append((ops.valid & binned.kept).to(torch.int32))
    inc = routing.dispatch(binned, payloads)

    it = iter(inc)
    b_in, k_in = next(it), next(it)
    v_in = next(it) if do_write else None
    o_in = next(it) if ops.op is not None else None
    m_in = next(it).to(torch.bool)
    val, found, code, n_mm, passes = _shard_apply(
        state, b_in, k_in, v_in, o_in, m_in, kinds)
    val_b, found_b, code_b = routing.collect(
        binned, [val, found.to(torch.int32), code])

    live = ops.valid & binned.kept
    found_out = (found_b > 0) & live
    code_out = torch.where(live, code_b, W_DROPPED)
    val_out = torch.where(found_out[:, None], val_b, 0)
    wire = routing.wire_stats(
        binned, routing.lane_width(payloads), cfg.val_words + 2,
        prologue_words=2 * cfg.n_shards if used_prologue else 0)
    bcounts = routing.bin_counts(binned)
    btotal = torch.clamp(bcounts.sum(), min=1).to(torch.float32)
    bmax = bcounts.max().to(torch.float32)
    estats = {
        "mismatches": n_mm,
        "rounds": passes,
        "lock_tokens": 0,
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
        "fallback_reads": 0,
    }
    obs_metrics.inc("engine.rounds")
    return state, None, val_out, found_out, code_out, estats


__all__ = [
    "KINDS", "OP_MIGRATE", "OP_READ", "OP_WRITE", "OpBatch", "W_DROPPED",
    "W_EVICT", "W_INSERT", "W_SKIP", "W_UPDATE", "dht_execute",
    "migrate_ops", "mixed_ops", "read_ops", "write_ops",
]
