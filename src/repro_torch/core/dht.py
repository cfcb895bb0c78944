"""DHT read/write wrappers over the one-round engine (PyTorch port of the
single-device part of ``repro.core.dht``).

Each call is one engine round (``core/op_engine.dht_execute``) on the
single-device virtual-shard backend, or, with ``axis_name`` a process
group, on the multi-rank backend (``state`` is the rank's one shard and
``keys`` its own rows; the stats are the rank's, reduced by
``core/distributed.py``).  :func:`dht_read_cached` serves the coherent
part of a batch from the L1 cache (``core/l1cache.py``) first.  The
``*_async``/``*_commit`` pairs are the two halves of the same rounds
(``dht_issue``/``dht_commit``): the async half enqueues the round and
returns, the commit half waits for it.  The table and the cache are
updated in place.  :func:`dht_read_dual` reads during an online
migration (``core/migrate.py``): each key fans out to its new- and
old-epoch owners inside one round.  :func:`dht_write_replicated` writes
each row to the k shards of its ring successor set in the same round;
under replication every read and cached read goes to the first live
replica of each key.
"""
from __future__ import annotations

import torch

from ..kernels import ops as kops
from ..obs import metrics as obs_metrics
from . import l1cache, routing
from .layout import DHTState, shard_watermark, to_i32
from .membership import ring_successors
from .op_engine import (
    W_DROPPED,
    W_EVICT,
    W_INSERT,
    W_UPDATE,
    InFlightRound,
    OpBatch,
    _owner_epoch,
    dht_commit,
    dht_execute,
    dht_issue,
    dual_fusable,
    read_ops,
    replica_placement,
    write_ops,
)


def _wire_skew_stats(es: dict) -> dict:
    """The wire-accounting and skew lanes every wrapper re-exports."""
    return {k: es[k] for k in (
        "epoch", "wire_words", "fill_frac", "bin_counts",
        "bin_max_load", "bin_imbalance", "hot_frac")}


def _read_stats(valid, found, es, *, l1_meta: bool = False) -> dict:
    stats = {
        "hits": found.sum().to(torch.int32),
        "misses": (valid & ~found).sum().to(torch.int32),
        "mismatches": es["mismatches"],
        "dropped": es["dropped"],
        "lock_tokens": es["lock_tokens"],
        "fallback_reads": es["fallback_reads"],
        **_wire_skew_stats(es),
    }
    if l1_meta:
        stats["wmark_post"] = es["wmark_post"]
    return stats


def _write_stats(code, es, *, l1_meta: bool = False) -> dict:
    stats = {
        "inserted": (code == W_INSERT).sum().to(torch.int32),
        "updated": (code == W_UPDATE).sum().to(torch.int32),
        "evicted": (code == W_EVICT).sum().to(torch.int32),
        "dropped": es["dropped"],
        "rounds": es["rounds"],
        "lock_tokens": es["lock_tokens"],
        **_wire_skew_stats(es),
        "code": code,
    }
    if l1_meta:
        stats["wmark_post"] = es["wmark_post"]
    return stats


def _ones(keys: torch.Tensor) -> torch.Tensor:
    return torch.ones(keys.shape[0], dtype=torch.bool, device=keys.device)


def dht_write_async(state: DHTState, keys: torch.Tensor, vals: torch.Tensor,
                    valid: torch.Tensor | None = None, *, axis_name=None,
                    l1_meta: bool = False) -> InFlightRound:
    """Issue a write round without waiting (the first half of
    :func:`dht_write`); pair with :func:`dht_write_commit`."""
    if valid is None:
        valid = _ones(keys)
    rnd = dht_issue(state, write_ops(keys, vals, valid), kinds=("write",),
                    axis_name=axis_name, l1_meta=l1_meta)
    rnd.meta["l1_meta"] = l1_meta
    return rnd


def dht_write_commit(rnd: InFlightRound) -> tuple[DHTState, dict]:
    """Commit an issued write round -> ``(state', stats)``."""
    state, _, _vals, _found, code, es = dht_commit(rnd)
    return state, _write_stats(code, es, l1_meta=rnd.meta["l1_meta"])


def dht_write(state: DHTState, keys: torch.Tensor, vals: torch.Tensor,
              valid: torch.Tensor | None = None, *, axis_name=None,
              l1_meta: bool = False, max_retries: int = 0
              ) -> tuple[DHTState, dict]:
    """DHT_write: store/update a batch of key-value pairs.

    ``l1_meta=True`` piggybacks the shard watermarks on the reply lanes
    (stats gain ``wmark_post``).  ``max_retries > 0`` re-issues rows the
    router dropped on a capacity overflow (``code == W_DROPPED``) for up
    to that many extra rounds; the default 0 is the single-round write.
    Under a process group there is no retry here (a rank's drops are not
    the group's): ``ShardedDHT.write`` retries on the global count."""
    if valid is None:
        valid = _ones(keys)
    state, _, _, _, code, es = dht_execute(
        state, write_ops(keys, vals, valid), kinds=("write",),
        axis_name=axis_name, l1_meta=l1_meta)
    total = _write_stats(code, es, l1_meta=l1_meta)
    if axis_name is not None:
        return state, total
    for _ in range(max_retries):
        retry = valid & (total["code"] == W_DROPPED)
        if not bool(retry.any()):
            break
        state, _, _, _, code, es = dht_execute(
            state, write_ops(keys, vals, retry), kinds=("write",),
            l1_meta=l1_meta)
        stats = _write_stats(code, es)
        for lane in ("inserted", "updated", "evicted", "lock_tokens",
                     "wire_words", "rounds"):
            total[lane] = total[lane] + stats[lane]
        # a retried row's fresh outcome overrides its drop code
        total["code"] = torch.where(retry, stats["code"], total["code"])
        total["dropped"] = (valid & (total["code"] == W_DROPPED)).sum().to(
            torch.int32)
        valid = retry
    return state, total


def dht_write_replicated(state: DHTState, keys: torch.Tensor,
                         vals: torch.Tensor,
                         valid: torch.Tensor | None = None, *,
                         axis_name=None, l1_meta: bool = False
                         ) -> tuple[DHTState, dict]:
    """DHT_write under k-successor replication: each row fans out to the
    ``cfg.n_replicas`` distinct shards of its ring successor set inside
    ONE engine round (``routing.flatten_fanout`` with the row's hash pair
    repeated and a precomputed placement), so replication costs wire
    words, never rounds.  The window base depends only on the low hash
    word, so every copy sits in the same probe window of its own slab.

    Copies bound for a dead shard are masked out of the routing; a row
    is **acknowledged** when at least one copy applied.  ``code`` is the
    first applied copy's code (``W_DROPPED`` where no copy landed, so a
    retry loop treats a row whose replicas are all down like an
    overflow).  Extra lanes: ``acked`` and ``replica_writes`` (secondary
    copies applied: the write amplification), 0-d tensors, and, beyond
    the reference's lanes, ``evicted_copies``: the copies that displaced
    a resident entry (``evicted`` counts each row's first copy only), the
    count that bounds what a crash can lose.

    At ``n_replicas == 1``, or with no ring, this is :func:`dht_write`,
    bit for bit."""
    cfg = state.cfg
    k = cfg.n_replicas
    if k == 1 or state.ring is None:
        state, stats = dht_write(state, keys, vals, valid,
                                 axis_name=axis_name, l1_meta=l1_meta)
        stats["replica_writes"] = torch.zeros((), dtype=torch.int32,
                                              device=keys.device)
        stats["acked"] = (stats["inserted"] + stats["updated"]
                          + stats["evicted"])
        stats["evicted_copies"] = stats["evicted"]
        return state, stats
    if valid is None:
        valid = _ones(keys)
    n = keys.shape[0]
    ring = state.ring.to(keys.device)
    h = kops.hash64(keys.contiguous())
    h_hi, h_lo = h[:, 0], h[:, 1]
    succ = ring_successors(ring, h_hi, k)                  # (n, k)
    ok = (succ >= 0) & ring.alive_dev[
        succ.clamp(0, cfg.n_shards - 1).long()]
    cvalid = valid[:, None] & ok                           # (n, k) copies
    flat_k, flat_valid = routing.flatten_fanout(
        keys[:, None, :].expand((n, k) + tuple(keys.shape[1:])), cvalid)
    flat_v, _ = routing.flatten_fanout(
        vals[:, None, :].expand((n, k) + tuple(vals.shape[1:])))
    dest = torch.where(flat_valid, succ.reshape(-1), 0).to(torch.int32)
    hashes = (h_hi.repeat_interleave(k), h_lo.repeat_interleave(k))
    cap = cfg.capacity
    state, _, _val, _found, code, es = dht_execute(
        state, OpBatch(keys=flat_k, valid=flat_valid,
                       vals=flat_v.to(torch.int32)),
        kinds=("write",), axis_name=axis_name,
        capacity=k * cap if cap else None, hashes=hashes,
        placement=(dest, ring.epoch), l1_meta=l1_meta)
    code2 = routing.unflatten_fanout(code, n, k)            # (n, k)
    applied = cvalid & (code2 != W_DROPPED)
    acked = applied.any(dim=-1)
    first = torch.argmax(applied.to(torch.int32), dim=-1)
    code_row = code2.gather(-1, first[:, None])[:, 0]
    code_row = torch.where(acked, code_row, W_DROPPED).to(torch.int32)
    stats = _write_stats(code_row, es, l1_meta=l1_meta)
    n_applied = applied.sum().to(torch.int32)
    n_acked = acked.sum().to(torch.int32)
    stats["acked"] = n_acked
    stats["replica_writes"] = n_applied - n_acked
    stats["evicted_copies"] = (applied & (code2 == W_EVICT)).sum().to(
        torch.int32)
    return state, stats


def dht_read_async(state: DHTState, keys: torch.Tensor,
                   valid: torch.Tensor | None = None, *, axis_name=None,
                   l1_meta: bool = False, pending=None) -> InFlightRound:
    """Issue a read round without waiting (the first half of
    :func:`dht_read`); pair with :func:`dht_read_commit`.  ``pending``
    is an optional ``core.pipeline.PendingWrites`` hazard filter: rows
    whose key has a promised-but-unissued write are served by forwarding
    at commit instead of probing a table that does not hold the value
    yet."""
    if valid is None:
        valid = _ones(keys)
    rnd = dht_issue(state, read_ops(keys, valid), kinds=("read",),
                    axis_name=axis_name, l1_meta=l1_meta, pending=pending)
    rnd.meta["valid"] = valid
    rnd.meta["l1_meta"] = l1_meta
    return rnd


def dht_read_commit(rnd: InFlightRound
                    ) -> tuple[DHTState, torch.Tensor, torch.Tensor, dict]:
    """Commit an issued read round -> ``(state', vals, found, stats)``.
    Forwarded rows count as hits: their value is bit for bit what the
    synchronous schedule would have read."""
    state, _, vals, found, _code, es = dht_commit(rnd)
    return state, vals, found, _read_stats(rnd.meta["valid"], found, es,
                                           l1_meta=rnd.meta["l1_meta"])


def dht_read(state: DHTState, keys: torch.Tensor,
             valid: torch.Tensor | None = None, *, axis_name=None,
             l1_meta: bool = False
             ) -> tuple[DHTState, torch.Tensor, torch.Tensor, dict]:
    """DHT_read: fetch a batch of values.  Returns ``(state', vals,
    found, stats)``; ``state'`` changes only where a checksum-failed
    bucket is flagged INVALID.  ``l1_meta=True`` adds the watermark
    piggyback (``wmark_post``) to the stats."""
    if valid is None:
        valid = _ones(keys)
    state, _, vals, found, _code, es = dht_execute(
        state, read_ops(keys, valid), kinds=("read",), axis_name=axis_name,
        l1_meta=l1_meta)
    return state, vals, found, _read_stats(valid, found, es,
                                           l1_meta=l1_meta)


def dht_read_cached_async(state: DHTState, l1: l1cache.L1State,
                          keys: torch.Tensor,
                          valid: torch.Tensor | None = None, *,
                          axis_name=None) -> InFlightRound:
    """Issue a cached read (the first half of :func:`dht_read_cached`):
    the L1 probe, the residue's engine round and the L1 refill, all
    enqueued; pair with :func:`dht_read_cached_commit`."""
    if valid is None:
        valid = _ones(keys)
    l1cfg = l1.cfg
    h = kops.hash64(keys.contiguous())
    hashes = (h[:, 0], h[:, 1])
    set_idx, way_idx = l1cache.l1_slots(l1cfg, *hashes)
    # under replication a dead owner's reads go to its first live
    # successor; the L1 refill below stamps ``owner=dest``, the SERVING
    # shard, so a line filled by a failover stays coherent against that
    # shard's watermark
    if state.cfg.n_replicas > 1 and state.ring is not None:
        dest, epoch, fb = replica_placement(state, hashes[0])
        n_fallback = (valid & fb).sum().to(torch.int32)
    else:
        dest, epoch = _owner_epoch(state, hashes[0])
        n_fallback = 0
    own = to_i32(shard_watermark(state.meta))
    if axis_name is None:
        # the whole table is at hand: every shard's watermark is
        # recomputed, so even edits made outside the engine fence
        known = own
    else:
        # this rank's shard recomputed, the others from the piggyback
        import torch.distributed as dist

        known = l1.shard_wmark.clone()
        known[dist.get_rank(routing.process_group(axis_name))] = own[0]
    # the liveness gate fences a crashed shard's lines (the crash's
    # epoch bump already does; the gate holds even without it)
    alive = (None if state.ring is None
             else state.ring.to(keys.device).alive_dev)
    flags = l1cache.serve_flags(l1, known, epoch, alive=alive)
    hit, cval = l1cache.l1_probe(l1cfg, l1, keys, set_idx, flags)
    hit = hit & valid

    rvalid = valid & ~hit
    rnd = dht_issue(
        state, OpBatch(keys=keys, valid=rvalid), kinds=("read",),
        axis_name=axis_name, hashes=hashes, placement=(dest, epoch),
        l1_meta=True)
    es, rval, rfound = rnd.estats, rnd.vals, rnd.found
    vals = torch.where(hit[:, None], cval, rval)
    found = hit | rfound

    gen = es.pop("bucket_gen")
    wpre, wpost = es.pop("wmark_pre"), es.pop("wmark_post")
    l1 = l1cache.with_shard_wmarks(l1, wpost)
    l1 = l1cache.l1_insert(l1cfg, l1, keys, rval, gen, dest,
                           wpre[dest.long()], epoch, set_idx, way_idx,
                           mask=rfound)
    if rnd.event is not None:
        rnd.event.record()          # the refill is part of the round
    rnd.meta.update(l1=l1, out=(vals, found), valid=valid,
                    local=axis_name is None, stats={
        "hits": found.sum().to(torch.int32),
        "misses": (valid & ~found).sum().to(torch.int32),
        "l1_hits": hit.sum().to(torch.int32),
        "mismatches": es["mismatches"],
        "dropped": es["dropped"],
        "lock_tokens": es["lock_tokens"],
        "fallback_reads": n_fallback,
        "epoch": es["epoch"],
        "wire_words": es["wire_words"],
        "fill_frac": es["fill_frac"],
        "bin_counts": es["bin_counts"],
        "bin_max_load": es["bin_max_load"],
        "bin_imbalance": es["bin_imbalance"],
        "hot_frac": es["hot_frac"],
    })
    return rnd


def dht_read_cached_commit(rnd: InFlightRound):
    """Commit an issued cached read -> ``(state', l1', vals, found,
    stats)``.  On the single-device backend it reads two counts back to
    the host for the ``l1.*`` counters (under a group the rank's counts
    are not the group's, so it does not)."""
    state = dht_commit(rnd)[0]
    vals, found = rnd.meta["out"]
    stats = rnd.meta["stats"]
    if rnd.meta["local"]:
        n_hits, n_queries = torch.stack(
            [stats["l1_hits"], rnd.meta["valid"].sum().to(torch.int32)]
        ).tolist()
        obs_metrics.inc("l1.hits", n_hits)
        obs_metrics.inc("l1.queries", n_queries)
    return state, rnd.meta["l1"], vals, found, stats


def dht_read_cached(state: DHTState, l1: l1cache.L1State, keys: torch.Tensor,
                    valid: torch.Tensor | None = None, *, axis_name=None):
    """DHT_read through the locality tier: coherent L1 hits are served
    from the cache with no routing traffic; only the residue rides the
    one-round engine, which piggybacks the coherence metadata used to
    refill the cache.  Under a process group the residue's self-owned
    rows also skip the exchange (``elide_self``).  The result is bit for
    bit :func:`dht_read`'s as long as every table mutation since the
    lines were filled changed the shard watermarks (engine rounds and
    INVALID flagging do).

    Returns ``(state', l1', vals, found, stats)``: ``stats`` matches
    :func:`dht_read` plus ``l1_hits``.  ``l1`` is updated in place."""
    return dht_read_cached_commit(dht_read_cached_async(
        state, l1, keys, valid, axis_name=axis_name))


def dht_read_many(state: DHTState, keys: torch.Tensor,
                  valid: torch.Tensor | None = None, *, axis_name=None,
                  l1_meta: bool = False
                  ) -> tuple[DHTState, torch.Tensor, torch.Tensor, dict]:
    """Batched multi-key read: ``keys`` (n, m, KW), e.g. the stencil
    neighbourhood of n queries, with an optional (n, m) ``valid`` mask;
    all n*m probes share ONE routing round.  Returns ``(state', vals
    (n, m, VW), found (n, m), stats)``."""
    n, m = keys.shape[0], keys.shape[1]
    flat, vflat = routing.flatten_fanout(keys, valid)
    state, val, found, stats = dht_read(state, flat, vflat,
                                        axis_name=axis_name, l1_meta=l1_meta)
    return (state, routing.unflatten_fanout(val, n, m),
            routing.unflatten_fanout(found, n, m), stats)


def dht_read_many_dual(state: DHTState, prev: DHTState, keys: torch.Tensor,
                       valid: torch.Tensor | None = None, *, axis_name=None):
    """Dual-epoch form of :func:`dht_read_many`: every one of the n*m
    probes fans out to its new- and old-epoch owners in the same single
    round (:func:`dht_read_dual`), so a neighbour still in flight is
    found.  Returns ``(state', prev', vals (n, m, VW), found (n, m),
    stats)``."""
    n, m = keys.shape[0], keys.shape[1]
    flat, vflat = routing.flatten_fanout(keys, valid)
    state, prev, val, found, stats = dht_read_dual(
        state, prev, flat, vflat, axis_name=axis_name)
    return (state, prev, routing.unflatten_fanout(val, n, m),
            routing.unflatten_fanout(found, n, m), stats)


def _dht_read_dual_seq(state: DHTState, prev: DHTState, keys: torch.Tensor,
                       valid: torch.Tensor, *, axis_name=None):
    """Two sequential reads: the fallback where the epochs' geometries
    cannot share one round (:func:`op_engine.dual_fusable` false, e.g. a
    rebuild that changed word widths or the probe window).  The second
    round reads only the first one's misses; ``fill_frac`` is weighted by
    each round's wire words (``obs.metrics.merge_wire_stats``) and the
    skew lanes come from the two rounds' summed bin counts (shard ids are
    stable, so the narrower histogram is zero-padded)."""
    state, val_new, found_new, s_new = dht_read(state, keys, valid,
                                                axis_name=axis_name)
    prev, val_old, found_old, s_old = dht_read(prev, keys, valid & ~found_new,
                                               axis_name=axis_name)
    vals, found = routing.merge_dual_epoch(found_new, val_new, found_old,
                                           val_old)
    wire = obs_metrics.merge_wire_stats(s_new, s_old)
    bc_n, bc_o = s_new["bin_counts"], s_old["bin_counts"]
    bc = torch.zeros(max(bc_n.shape[0], bc_o.shape[0]), dtype=bc_n.dtype,
                     device=bc_n.device)
    bc[:bc_n.shape[0]] += bc_n
    bc[:bc_o.shape[0]] += bc_o
    btot = torch.clamp(bc.sum(), min=1).to(torch.float32)
    bmax = bc.max().to(torch.float32)
    stats = {
        "hits": (s_new["hits"] + s_old["hits"]).to(torch.int32),
        "misses": (valid & ~found).sum().to(torch.int32),
        "mismatches": s_new["mismatches"] + s_old["mismatches"],
        "dropped": s_new["dropped"] + s_old["dropped"],
        "lock_tokens": s_new["lock_tokens"] + s_old["lock_tokens"],
        "epoch": s_new["epoch"],
        "wire_words": wire["wire_words"],
        "fill_frac": wire["fill_frac"],
        "bin_counts": bc,
        "bin_max_load": bc.max(),
        "bin_imbalance": bmax * float(bc.shape[0]) / btot,
        "hot_frac": bmax / btot,
        "hits_old_epoch": s_old["hits"],
    }
    return state, prev, vals, found, stats


def dht_read_dual(state: DHTState, prev: DHTState, keys: torch.Tensor,
                  valid: torch.Tensor | None = None, *, axis_name=None):
    """Dual-epoch read during an online migration.

    Between ``migration_begin`` and ``migration_finish`` an entry lives
    in the new-epoch table ``state`` (moved already, or written since)
    or in the frozen previous-epoch table ``prev`` (not moved yet).  Each
    key fans out to BOTH owners inside one round of capacity ``2 * cap``
    (an epoch-select lane; the shard side probes each epoch's slab): the
    new epoch's reply is authoritative, the old one backfills entries in
    flight, so no hit is lost mid-move.  ``stats`` adds
    ``hits_old_epoch``, the hits only the old epoch served.

    Returns ``(state', prev', vals, found, stats)``."""
    if valid is None:
        valid = _ones(keys)
    if not dual_fusable(state.cfg, prev.cfg):
        return _dht_read_dual_seq(state, prev, keys, valid,
                                  axis_name=axis_name)
    n = keys.shape[0]
    flat = keys[:, None, :].expand((n, 2) + tuple(keys.shape[1:]))
    flat = flat.reshape((2 * n,) + tuple(keys.shape[1:]))
    vflat = valid[:, None].expand(n, 2).reshape(2 * n)
    esel = torch.arange(2, dtype=torch.int32, device=keys.device).repeat(n)
    cap = state.cfg.capacity
    state, prev, val, found, _code, es = dht_execute(
        state, OpBatch(keys=flat, valid=vflat, esel=esel), kinds=("read",),
        prev=prev, axis_name=axis_name, capacity=2 * cap if cap else None)
    val2 = routing.unflatten_fanout(val, n, 2)
    fnd2 = routing.unflatten_fanout(found, n, 2)
    vals, fnd = routing.merge_dual_epoch(fnd2[:, 0], val2[:, 0],
                                         fnd2[:, 1], val2[:, 1])
    stats = {
        "hits": fnd.sum().to(torch.int32),
        "misses": (valid & ~fnd).sum().to(torch.int32),
        "mismatches": es["mismatches"],
        "dropped": es["dropped"],
        "lock_tokens": es["lock_tokens"],
        **_wire_skew_stats(es),
        "hits_old_epoch": (fnd2[:, 1] & ~fnd2[:, 0]).sum().to(torch.int32),
    }
    return state, prev, vals, fnd, stats


def dht_read_many_async(state: DHTState, keys: torch.Tensor,
                        valid: torch.Tensor | None = None, *, axis_name=None,
                        l1_meta: bool = False, pending=None) -> InFlightRound:
    """Issue a multi-key (n, m, KW) read round without waiting; pair with
    :func:`dht_read_many_commit`."""
    n, m = keys.shape[0], keys.shape[1]
    flat, vflat = routing.flatten_fanout(keys, valid)
    rnd = dht_read_async(state, flat, vflat, axis_name=axis_name,
                         l1_meta=l1_meta, pending=pending)
    rnd.meta["fanout"] = (n, m)
    return rnd


def dht_read_many_commit(rnd: InFlightRound
                         ) -> tuple[DHTState, torch.Tensor, torch.Tensor,
                                    dict]:
    """Commit an issued multi-key read -> ``(state', vals (n, m, VW),
    found (n, m), stats)``."""
    state, val, found, stats = dht_read_commit(rnd)
    n, m = rnd.meta["fanout"]
    return (state, routing.unflatten_fanout(val, n, m),
            routing.unflatten_fanout(found, n, m), stats)
