"""Sharded execution of the DHT over ``torch.distributed`` (PyTorch port of
``repro.core.distributed``).

Every rank contributes one table shard (the paper: "the parallel
processes offer a part of their available memory"): a group of S ranks
holds a table of ``cfg.n_shards == S`` shards, rank r shard r.  Each rank
calls the same wrappers with its own rows; the group's batch is the
ranks' batches in rank order, the reference's ``P(axes)`` row blocks.
Every round is one ``all_to_all_single`` each way (``core/routing.py``),
gloo for CPU tensors and NCCL for CUDA ones.

Each wrapper's stat lanes are reduced over the group the way the
reference's ``_psum_stats`` reduces them: one packed ``all_reduce(SUM)``
and one ``all_reduce(MAX)``, launched without waiting; a mean lane is the
sum over the world size; the per-row ``code`` stays the rank's.  The
``*_fn`` closures are plain functions with the reference's signatures
``(state, keys, vals, valid) -> ...``; the port is eager, so they need no
trace cache.

Elastic membership: a table made with a consistent-hash ``ring`` places
keys by it on every rank, and :meth:`ShardedDHT.apply_ring` (``leave``,
``join``) reshards online in lockstep.  Each rank plans its own sources
(its live entries whose new owner is another rank) and snapshots their
rows first; the ranks agree on the number of migrate rounds with one
``all_reduce(MAX)``; every round is one get-or-put exchange round in
which each rank sends at most ``batch // world`` rows (an all-invalid
batch once it has run out); the counts meet in one ``all_reduce(SUM)``
and each rank retires its own stale sources.  No dual reads are needed:
the call returns when the move is done.

k-successor replication: with ``cfg.n_replicas > 1`` and a ring,
:meth:`ShardedDHT.write` fans every row out to its k ring successors in
the same exchange round (``write_replicated_fn``), and reads go to the
first live replica.  :meth:`ShardedDHT.crash` drops a shard's liveness
bit on every rank (the victim zeroes its own slab), :meth:`recover`
raises it again, and :meth:`repair` heals the recovered shard in
lockstep: the ranks agree on the reference's global repair plan by
gathering their candidates' (flat index, hash) words, the members of a
hash group compare their key rows, the candidates' keys travel to the
recovered rank once for the presence probe, and each get-or-put round
carries, from every rank, its own source rows of the plan's slice, so
the recovered rank receives them in the plan's order.

Telemetry: under a group the engine records nothing itself; each
wrapper records the group's reduced lanes as one round of the trace
(``sharded.write``, ``sharded.read``, ``sharded.read_cached``,
``sharded.read_many``, the ``sharded.migrate`` and ``sharded.repair``
rounds) and the trace-only events ``sharded.apply_ring``,
``sharded.crash``, ``sharded.recover`` and ``sharded.repair_run``, so
every rank's registry holds what the reference's single process holds
(:meth:`ShardedDHT.telemetry_snapshot`).  The migrate and repair rounds
reduce their lanes only while recording is on, so every rank of a group
must record, or none.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any

import torch
import torch.distributed as dist

from ..kernels import ops as kops
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from . import dht as dht_ops
from . import l1cache, routing
from .hashing import base_bucket
from .layout import DHTConfig, DHTState, dht_create, live_mask, resolve_device
from .membership import (
    ring_crash,
    ring_create,
    ring_join,
    ring_leave,
    ring_recover,
    ring_successors,
)
from .faults import wipe_shard
from .migrate import (
    _owners,
    _retire,
    first_copies,
    hash_key64,
    repair_round,
    window_present,
)
from .op_engine import (
    W_DROPPED,
    W_EVICT,
    InFlightRound,
    OpBatch,
    dht_commit,
    dht_execute,
    migrate_ops,
)
from .pipeline import RoundQueue

# replicated or uniform lanes, and the largest bin: the max over ranks
_MAX_LANES = ("rounds", "epoch", "dispatch_rounds", "n_shards", "capacity",
              "bin_max_load")
# per-rank fractions: the mean over ranks
_MEAN_LANES = ("fill_frac", "bin_imbalance", "hot_frac")
# a recorded group round's rows, summed over the ranks beside its lanes
_OPS_LANE = "ops:"


class ReducedStats:
    """A rank's stat lanes on their way to the group's.  The lanes are
    packed into one float64 buffer per reduction (int32 counts and the
    float32 fractions are exact in it; one ``cat`` casts them all), and
    the two ``all_reduce`` calls are launched without waiting;
    :meth:`wait` waits for them and unpacks 0-d int32 (float32 for the
    mean lanes) tensors on the rank's device.  ``code`` is per row and
    stays the rank's.

    ``pin=True`` (a round that will be recorded): on the card the reduced
    buffers are also copied, in stream order after the reductions and
    without waiting, into pinned host memory, so :meth:`host_lanes`
    reads the group's scalar lanes after an event with no sync of its
    own."""

    def __init__(self, stats: dict, group, device: torch.device, *,
                 pin: bool = False):
        self.world = dist.get_world_size(group)
        self.order = [k for k in stats if k != "code"]
        self.kept = {k: v for k, v in stats.items() if k == "code"}
        self.layout: dict[str, list] = {}
        self.bufs, self.works = {}, []
        for red in ("sum", "max"):
            names = [k for k in stats if k != "code"
                     and (k in _MAX_LANES) == (red == "max")]
            host = [k for k in names if not torch.is_tensor(stats[k])]
            dev = [k for k in names if torch.is_tensor(stats[k])]
            # host numbers first, then the device lanes in order
            head = torch.tensor([float(stats[k]) for k in host],
                                dtype=torch.float64)
            if device.type == "cuda":
                # a pinned copy: no host sync in the issue half
                head = head.pin_memory().to(device, non_blocking=True)
            buf = torch.cat([head] + [stats[k].reshape(-1) for k in dev])
            layout, off = [], 0
            for k in host + dev:
                shape = tuple(stats[k].shape) if k in dev else ()
                n = max(1, int(torch.Size(shape).numel()))
                layout.append((k, off, n, shape))
                off += n
            op = dist.ReduceOp.SUM if red == "sum" else dist.ReduceOp.MAX
            self.works.append(dist.all_reduce(buf, op=op, group=group,
                                              async_op=True))
            self.bufs[red], self.layout[red] = buf, layout
        self._out: dict | None = None
        self._waited = False
        self._pinned = self._pinned_event = None
        if pin and device.type == "cuda":
            # NCCL's wait orders the current stream after the reductions
            # without blocking the host
            self._wait_works()
            self._pinned = {}
            for red, buf in self.bufs.items():
                self._pinned[red] = torch.empty(
                    buf.shape, dtype=torch.float64, pin_memory=True)
                self._pinned[red].copy_(buf, non_blocking=True)
            self._pinned_event = torch.cuda.Event()
            self._pinned_event.record()

    def _wait_works(self) -> None:
        if not self._waited:
            for w in self.works:
                w.wait()
            self._waited = True

    def _unpack(self, bufs: dict) -> dict:
        out = {}
        for red, layout in self.layout.items():
            ints = bufs[red].to(torch.int32)
            fracs = None
            for k, off, n, shape in layout:
                if k in _MEAN_LANES:
                    if fracs is None:
                        fracs = bufs[red].to(torch.float32) / float(
                            self.world)
                    out[k] = fracs[off:off + n].reshape(shape)
                else:
                    out[k] = ints[off:off + n].reshape(shape)
        return out

    def wait(self) -> dict:
        """The group's lanes (the same on every rank) and the rank's
        ``code``."""
        if self._out is None:
            self._wait_works()
            self._out = {**self._unpack(self.bufs), **self.kept}
        return dict(self._out)

    def host_lanes(self) -> dict:
        """The group's scalar lanes as Python numbers, in the stats'
        order (what :meth:`wait` unpacks; vector lanes left out): from
        the pinned copy after its event where the round made one, else
        with one copy of the unpacked lanes."""
        if self._pinned is None:
            lanes = obs_trace._scalarize(self.wait())
        else:
            self._pinned_event.synchronize()
            lanes = obs_trace._scalarize(self._unpack(self._pinned))
        return {k: lanes[k] for k in self.order if k in lanes}


def _psum_stats(stats: dict, group) -> dict:
    """The group's stat lanes, synchronously (see :class:`ReducedStats`)."""
    device = next((v.device for v in stats.values() if torch.is_tensor(v)),
                  torch.device("cpu"))
    return ReducedStats(stats, group, device).wait()


def _rank_device(group, device) -> torch.device:
    """The caller's device, or this rank's card: ``cuda:{LOCAL_RANK}``
    (the rank modulo the card count when the launcher sets none).
    Without CUDA and without a device it raises, as every entry point of
    the port does."""
    if device is not None:
        return resolve_device(device)
    resolve_device(None)
    local = os.environ.get("LOCAL_RANK")
    local = (int(local) if local is not None
             else dist.get_rank(group) % torch.cuda.device_count())
    return torch.device("cuda", local)


@dataclasses.dataclass
class ShardedRound:
    """An issued-but-uncommitted sharded round: the engine's
    :class:`InFlightRound` (its event and telemetry lanes), the results
    the matching ``*_commit`` returns, the stat lanes' reductions in
    flight, and what the commit records: the group's op counts and the
    issue half's start and end on the host clock."""

    source: str
    rnd: InFlightRound
    outs: tuple
    stats: ReducedStats
    ops: dict
    t_start: float
    t_issued: float
    committed: bool = False


@dataclasses.dataclass
class ShardedDHT:
    """The multi-rank table bound to a process group: this rank's shard,
    its private L1 (``l1cfg``), and the read/write wrappers.

    With ``l1cfg`` set, every rank fronts its reads with the locality
    tier: reads probe the rank's L1 before routing and elide self-owned
    rows from the exchange; every round, reads and writes, refreshes the
    shard watermarks from the reply piggyback, which is what invalidates
    cached lines a remote write obsoleted.  All table mutations must then
    go through this object's wrappers.

    ``pipeline_depth`` is the depth of :meth:`round_queue` for the
    issue/commit wrappers (:meth:`read_async` / :meth:`write_async`).  A
    pipelined driver's ``PendingWrites`` must hold the group's promises,
    not the rank's: a row may repeat a key another rank is about to
    write (gather the batch's keys and miss masks across ranks).

    Each wrapper records its round with the group's lanes and the
    group's op counts, taken as the rank's rows times the world size:
    the ranks' batches are of one size, as the reference's global batch
    is cut.  Every rank must record, or none (``obs.metrics``)."""

    cfg: DHTConfig
    state: DHTState
    group: Any
    l1cfg: l1cache.L1Config | None = None
    l1: l1cache.L1State | None = None
    pipeline_depth: int = 2
    # one all-true valid mask per batch shape
    _ones_cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def create(cls, cfg: DHTConfig, *, group=None,
               l1cfg: l1cache.L1Config | None = None, device=None,
               ring=None) -> "ShardedDHT":
        """This rank's empty shard of a ``cfg.n_shards``-shard table.
        ``group`` defaults to the whole world, which must have
        ``cfg.n_shards`` ranks.  The shard lives on this rank's card
        unless ``device`` names another; the group's backend must fit it
        (NCCL for CUDA, gloo for the CPU).  ``ring`` (a
        ``membership.RingState`` of ``cfg.n_shards`` shards, the same on
        every rank) places keys on a consistent-hash ring."""
        if ring is not None and ring.n_shards != cfg.n_shards:
            raise ValueError(f"a ring of {ring.n_shards} shards for "
                             f"n_shards={cfg.n_shards}")
        if not dist.is_initialized():
            raise RuntimeError("ShardedDHT needs torch.distributed: call "
                               "init_process_group first")
        group = dist.group.WORLD if group is None else group
        world = dist.get_world_size(group)
        if cfg.n_shards != world:
            raise ValueError(f"one shard per rank: n_shards={cfg.n_shards} "
                             f"!= world size {world}")
        dev = _rank_device(group, device)
        routing.process_group(group, dev)
        state = dht_create(cfg, ring, device=dev, shards=1)
        l1 = None
        if l1cfg is not None:
            if (l1cfg.key_words, l1cfg.val_words) != (cfg.key_words,
                                                      cfg.val_words):
                l1cfg = dataclasses.replace(
                    l1cfg, key_words=cfg.key_words, val_words=cfg.val_words)
            l1 = l1cache.l1_create(l1cfg, cfg.n_shards, device=dev)
        return cls(cfg=cfg, state=state, group=group, l1cfg=l1cfg, l1=l1)

    # -- closures ---------------------------------------------------------
    def _no_l1(self, what: str) -> None:
        if self.l1 is not None:
            raise ValueError(
                f"L1 attached: {what} through write() (write_refresh_fn) so "
                "the coherence watermarks refresh; a raw write round would "
                "let stale cached lines keep serving")

    def write_fn(self):
        """``(state, keys, vals, valid) -> (state', stats)``."""
        self._no_l1("write")

        def fn(state, keys, vals, valid):
            state, stats = dht_ops.dht_write(state, keys, vals, valid,
                                             axis_name=self.group)
            return state, _psum_stats(stats, self.group)

        return fn

    def read_fn(self):
        """``(state, keys, valid) -> (state', vals, found, stats)``."""

        def fn(state, keys, valid):
            state, vals, found, stats = dht_ops.dht_read(
                state, keys, valid, axis_name=self.group)
            return state, vals, found, _psum_stats(stats, self.group)

        return fn

    def execute_fn(self, kinds: tuple[str, ...]):
        """The one-round op-engine for uniform-kind batches:
        ``("migrate",)`` is get-or-put; ``("read",)``/``("write",)``
        mirror :meth:`read_fn`/:meth:`write_fn`.  ``(state, keys, vals,
        valid) -> (state', vals, found, code, estats)``."""
        if "write" in kinds:
            self._no_l1("a same-epoch write round")
        do_write = ("write" in kinds) or ("migrate" in kinds)

        def fn(state, keys, vals, valid):
            ops = OpBatch(keys=keys, valid=valid,
                          vals=vals.to(torch.int32) if do_write else None)
            state, _, out, found, code, es = dht_execute(
                state, ops, kinds=kinds, axis_name=self.group)
            return state, out, found, code, _psum_stats(es, self.group)

        return fn

    def read_many_fn(self):
        """Neighbourhood read: (n, m, KW) candidate keys a row, all probed
        in ONE exchange round.  ``(state, keys, valid) -> (state', vals,
        found, stats)``."""

        def fn(state, keys, valid):
            state, vals, found, stats = dht_ops.dht_read_many(
                state, keys, valid, axis_name=self.group)
            return state, vals, found, _psum_stats(stats, self.group)

        return fn

    def read_cached_fn(self):
        """L1-fronted read: coherent hot keys are served by the rank, the
        self-owned residue skips the exchange, and the round's reply lanes
        refresh the watermarks.  ``(state, l1, keys, valid) -> (state',
        l1', vals, found, stats)``."""

        def fn(state, l1, keys, valid):
            state, l1, vals, found, stats = dht_ops.dht_read_cached(
                state, l1, keys, valid, axis_name=self.group)
            return state, l1, vals, found, _psum_stats(stats, self.group)

        return fn

    def write_refresh_fn(self):
        """Write round that also refreshes the L1 watermarks: the
        piggybacked post-round watermarks invalidate every cached line
        the write obsoleted, on every rank.  ``(state, l1, keys, vals,
        valid) -> (state', l1', stats)``."""

        def fn(state, l1, keys, vals, valid):
            state, stats = dht_ops.dht_write(
                state, keys, vals, valid, axis_name=self.group,
                l1_meta=True)
            l1 = l1cache.with_shard_wmarks(l1, stats.pop("wmark_post"))
            return state, l1, _psum_stats(stats, self.group)

        return fn

    def read_many_refresh_fn(self):
        """Neighbourhood read that refreshes the L1 watermarks (its round
        may flag INVALID buckets).  ``(state, l1, keys, valid) ->
        (state', l1', vals, found, stats)``."""

        def fn(state, l1, keys, valid):
            state, vals, found, stats = dht_ops.dht_read_many(
                state, keys, valid, axis_name=self.group, l1_meta=True)
            l1 = l1cache.with_shard_wmarks(l1, stats.pop("wmark_post"))
            return state, l1, vals, found, _psum_stats(stats, self.group)

        return fn

    def write_replicated_fn(self):
        """Replicated write round (``dht.dht_write_replicated``): every
        row fans out to its k ring successors inside the same exchange
        round.  :meth:`write` takes it when ``cfg.n_replicas > 1`` and a
        ring is attached.  ``(state, keys, vals, valid) -> (state',
        stats)``; ``stats`` adds ``acked`` and ``replica_writes``."""
        self._no_l1("write")

        def fn(state, keys, vals, valid):
            state, stats = dht_ops.dht_write_replicated(
                state, keys, vals, valid, axis_name=self.group)
            return state, _psum_stats(stats, self.group)

        return fn

    def write_replicated_refresh_fn(self):
        """Replicated write that also refreshes the L1 watermarks (the
        copies move k shards' watermarks in one round).  ``(state, l1,
        keys, vals, valid) -> (state', l1', stats)``."""

        def fn(state, l1, keys, vals, valid):
            state, stats = dht_ops.dht_write_replicated(
                state, keys, vals, valid, axis_name=self.group,
                l1_meta=True)
            l1 = l1cache.with_shard_wmarks(l1, stats.pop("wmark_post"))
            return state, l1, _psum_stats(stats, self.group)

        return fn

    def repair_fn(self):
        """Anti-entropy get-or-put round pinned to an explicit destination
        (the recovered shard; the replica select would send the rows to
        their live owners, which hold them already).  ``(state, keys,
        vals, valid, dest) -> (state', found, code, estats)``."""

        def fn(state, keys, vals, valid, dest):
            state, _, _out, found, code, es = dht_execute(
                state, migrate_ops(keys, vals, valid), kinds=("migrate",),
                axis_name=self.group, placement=(dest, state.ring.epoch))
            return state, found, code, _psum_stats(es, self.group)

        return fn

    # -- stateful wrappers --------------------------------------------------
    def _ones(self, shape) -> torch.Tensor:
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        mask = self._ones_cache.get(shape)
        if mask is None:
            mask = torch.ones(shape, dtype=torch.bool,
                              device=self.state.device)
            self._ones_cache[shape] = mask
        return mask

    @property
    def replicated(self) -> bool:
        """Writes fan out to k ring successors."""
        return self.cfg.n_replicas > 1 and self.ring is not None

    def _write_dispatch(self, keys, vals, valid) -> dict:
        if self.l1 is not None:
            fn = (self.write_replicated_refresh_fn() if self.replicated
                  else self.write_refresh_fn())
            self.state, self.l1, stats = fn(self.state, self.l1, keys, vals,
                                            valid)
        else:
            fn = (self.write_replicated_fn() if self.replicated
                  else self.write_fn())
            self.state, stats = fn(self.state, keys, vals, valid)
        return stats

    def _n_retry(self, stats: dict, retry: torch.Tensor) -> int:
        """The group's count of rows to re-issue.  Unreplicated, the
        group's dropped lane counts exactly them (a routed row always
        comes back with a write code); replicated, ``dropped`` counts
        copies and a row drops only when none of its copies applied, so
        the rows are summed over the group."""
        if not self.replicated:
            return int(stats["dropped"])
        n = retry.sum().reshape(1)
        dist.all_reduce(n, op=dist.ReduceOp.SUM, group=self.group)
        return int(n.item())

    def write(self, keys, vals, valid=None, *, max_retries: int = 2) -> dict:
        """Write this rank's rows; rows dropped (on an overflow, or with
        every replica down) are re-issued up to ``max_retries`` times.
        The retry decision is the group's (every rank takes the same
        number of rounds); only the final round's unrecovered drops stay
        on ``dropped``, and ``write_retries`` counts the extra rounds."""
        valid = self._ones(keys.shape[0]) if valid is None else valid
        n_ops = self._group_rows(keys.shape[0])
        total = None
        attempt = 0
        while True:
            t_a = time.perf_counter()
            stats = self._write_dispatch(keys, vals, valid)
            code = stats["code"]
            retry = valid & (code == W_DROPPED)
            n_retry = self._n_retry(stats, retry)
            final = n_retry == 0 or attempt >= max_retries
            flush = dict(stats)
            if not final:
                # this round's drops are about to be re-issued: flush
                # them as requeued, so engine.dropped keeps meaning "lost
                # for good"
                flush["requeued"] = flush.pop("dropped")
            obs_trace.record_round("sharded.write", flush,
                                   ops={"write": n_ops}, t_start=t_a)
            if total is None:
                total = dict(stats)
            else:
                for lane in ("inserted", "updated", "evicted", "acked",
                             "replica_writes", "evicted_copies",
                             "lock_tokens", "wire_words", "rounds"):
                    if lane in total:
                        total[lane] = total[lane] + stats[lane]
                # a retried row's fresh outcome overrides its drop code
                total["code"] = torch.where(code != W_DROPPED, code,
                                            total["code"])
                total["dropped"] = stats["dropped"]
            if final:
                total["write_retries"] = attempt
                return total
            attempt += 1
            n_ops = n_retry
            valid = retry

    def _group_rows(self, n: int) -> int:
        """The group's rows of a call, each rank passing ``n``."""
        return n * dist.get_world_size(self.group)

    def read(self, keys, valid=None):
        """Read this rank's rows -> ``(vals, found, stats)``."""
        t0 = time.perf_counter()
        valid = self._ones(keys.shape[0]) if valid is None else valid
        if self.l1 is not None:
            self.state, self.l1, vals, found, stats = self.read_cached_fn()(
                self.state, self.l1, keys, valid)
            source = "sharded.read_cached"
        else:
            self.state, vals, found, stats = self.read_fn()(
                self.state, keys, valid)
            source = "sharded.read"
        obs_trace.record_round(
            source, stats, ops={"read": self._group_rows(keys.shape[0])},
            t_start=t0)
        return vals, found, stats

    def read_many(self, keys, valid=None):
        """Neighbourhood read of this rank's (n, m, KW) rows -> ``(vals,
        found, stats)``."""
        t0 = time.perf_counter()
        valid = self._ones(keys.shape[:2]) if valid is None else valid
        if self.l1 is not None:
            self.state, self.l1, vals, found, stats = \
                self.read_many_refresh_fn()(self.state, self.l1, keys, valid)
        else:
            self.state, vals, found, stats = self.read_many_fn()(
                self.state, keys, valid)
        obs_trace.record_round(
            "sharded.read_many", stats,
            ops={"read": self._group_rows(keys.shape[0] * keys.shape[1])},
            t_start=t0)
        return vals, found, stats

    # -- issue/commit wrappers ----------------------------------------------
    # The issue half enqueues the round and launches the stat lanes'
    # reductions; the commit half waits for the round's event and the
    # reductions.  Nothing here reads a device value back to the host
    # beyond what the engine's issue half reads (the agreed capacity, the
    # write passes' flags); a recorded round's reduced lanes reach the
    # host through a pinned copy read after its event.

    def read_async(self, keys, valid=None) -> ShardedRound:
        """Issue a read round without waiting; pair with
        :meth:`read_commit`.  At most ``pipeline_depth`` rounds should be
        in flight (use :meth:`round_queue`)."""
        t0 = time.perf_counter()
        valid = self._ones(keys.shape[0]) if valid is None else valid
        if self.l1 is not None:
            rnd = dht_ops.dht_read_cached_async(
                self.state, self.l1, keys, valid, axis_name=self.group)
            self.l1 = rnd.meta["l1"]
            outs, stats = rnd.meta["out"], rnd.meta["stats"]
            source = "sharded.read_cached"
        else:
            rnd = dht_ops.dht_read_async(self.state, keys, valid,
                                         axis_name=self.group)
            outs = (rnd.vals, rnd.found)
            stats = dht_ops._read_stats(valid, rnd.found, rnd.estats)
            source = "sharded.read"
        return ShardedRound(
            source=source, rnd=rnd, outs=outs,
            stats=ReducedStats(stats, self.group, self.state.device,
                               pin=obs_metrics.enabled()),
            ops={"read": self._group_rows(keys.shape[0])}, t_start=t0,
            t_issued=time.perf_counter())

    def write_async(self, keys, vals, valid=None) -> ShardedRound:
        """Issue a write round without waiting; pair with
        :meth:`write_commit`.  No retry here: it would need the drop
        count mid-pipeline; the caller re-issues dropped rows."""
        t0 = time.perf_counter()
        valid = self._ones(keys.shape[0]) if valid is None else valid
        l1_meta = self.l1 is not None
        rnd = dht_ops.dht_write_async(self.state, keys, vals, valid,
                                      axis_name=self.group, l1_meta=l1_meta)
        stats = dht_ops._write_stats(rnd.code, rnd.estats, l1_meta=l1_meta)
        if l1_meta:
            self.l1 = l1cache.with_shard_wmarks(self.l1,
                                                stats.pop("wmark_post"))
        return ShardedRound(
            source="sharded.write", rnd=rnd, outs=(rnd.code,),
            stats=ReducedStats(stats, self.group, self.state.device,
                               pin=obs_metrics.enabled()),
            ops={"write": self._group_rows(keys.shape[0])}, t_start=t0,
            t_issued=time.perf_counter())

    def _commit(self, sr: ShardedRound) -> tuple:
        """Wait for an issued round -> ``outs + (stats,)``; ``stats``
        gains the engine round's telemetry lanes (``issue_us``,
        ``hidden_us``, ``commit_wait_us``, ``overlap_frac``).  Records
        the round with ``issue``/``hidden``/``commit`` spans."""
        if sr.committed:
            raise RuntimeError("ShardedRound committed twice")
        sr.committed = True
        t_commit = time.perf_counter()
        dht_commit(sr.rnd)
        stats = sr.stats.wait()
        stats.update(sr.rnd.telemetry)
        if obs_metrics.enabled():
            obs_trace.record_round(
                sr.source, {**sr.stats.host_lanes(), **sr.rnd.telemetry},
                ops=sr.ops, t_start=sr.t_start,
                phase_marks=[("issue", sr.t_start), ("hidden", sr.t_issued),
                             ("commit", t_commit)])
        return sr.outs + (stats,)

    def read_commit(self, sr: ShardedRound):
        """Commit an issued read -> ``(vals, found, stats)``."""
        if sr.source not in ("sharded.read", "sharded.read_cached"):
            raise ValueError(f"not a read round: {sr.source}")
        return self._commit(sr)

    def write_commit(self, sr: ShardedRound) -> dict:
        """Commit an issued write -> ``stats``."""
        if sr.source != "sharded.write":
            raise ValueError(f"not a write round: {sr.source}")
        return self._commit(sr)[-1]

    def round_queue(self, commit=None) -> RoundQueue:
        """A ``pipeline_depth``-deep FIFO of this table's in-flight
        rounds; ``commit`` defaults to :meth:`_commit`."""
        return RoundQueue(self.pipeline_depth, commit or self._commit)

    def telemetry_snapshot(self) -> dict:
        """This rank's registry snapshot (plain JSON).  Every rank records
        the group's reduced lanes, so each rank's snapshot is what the
        reference's one process holds; merging the ranks' snapshots
        (``obs.metrics.merge_snapshots``) therefore multiplies the counts
        by the world size, as merging a snapshot with itself does."""
        return obs_metrics.get_registry().snapshot()

    # -- elastic membership -------------------------------------------------
    @property
    def ring(self):
        return self.state.ring

    def apply_ring(self, new_ring, batch: int = 512) -> dict:
        """Online in-place resharding to ``new_ring``, in lockstep on
        every rank (see the module's docstring).  ``batch`` is the
        group's rows a round, ``batch // world`` from each rank.
        Returns the group's ``{n_live, n_planned, moved,
        evicted_at_dest, epoch}``."""
        cfg, st = self.cfg, self.state
        world = dist.get_world_size(self.group)
        me = dist.get_rank(self.group)
        if new_ring.n_shards != cfg.n_shards:
            raise ValueError("the multi-rank backend reshards in place: "
                             f"a ring of {cfg.n_shards} shards, got "
                             f"{new_ring.n_shards}")
        per = max(batch // world, 1)
        dev = st.device
        new_ring = new_ring.to(dev)
        # plan this rank's sources and snapshot their rows (and the dump
        # row: the pad of the invalid rows) before any round writes
        live = live_mask(st.meta).reshape(-1)
        owner = _owners(st.flat_keys[:-1], new_ring)
        src = torch.nonzero(live & (owner != me)).reshape(-1)
        idx = torch.cat([src, src.new_full((1,), st.flat_meta.shape[0] - 1)])
        src_keys, src_vals = st.flat_keys[idx], st.flat_vals[idx]
        n_src = int(src.shape[0])
        agreed = torch.tensor([-(-n_src // per)], dtype=torch.int64,
                              device=dev)
        dist.all_reduce(agreed, op=dist.ReduceOp.MAX, group=self.group)
        n_rounds = int(agreed.item())
        # the new epoch: the same buffers, capacity ``per`` (no rank
        # sends more rows a round, so no bin overflows)
        new = DHTState(dataclasses.replace(cfg, capacity=per), st.flat_keys,
                       st.flat_vals, st.flat_meta, st.flat_csum, new_ring)
        counts = torch.zeros(3, dtype=torch.int64, device=dev)
        iota = torch.arange(per, device=dev)
        for r in range(n_rounds):
            t_b = time.perf_counter()
            pos = iota + r * per
            valid = pos < n_src
            rows = torch.clamp(pos, max=n_src)   # past the end: the pad
            _, _, _, found, code, es = dht_execute(
                new, migrate_ops(src_keys[rows], src_vals[rows], valid),
                kinds=("migrate",), axis_name=self.group)
            counts += torch.stack([(valid & ~found).sum(),
                                   (code == W_EVICT).sum(),
                                   es["dropped"].to(torch.int64)])
            self._record_group_round("sharded.migrate", es, "migrate",
                                     valid, t_b)
        # retire this rank's sources whose stored key now lives elsewhere
        _retire(new, src, new_ring, shard_offset=me)
        self.state = DHTState(cfg, new.flat_keys, new.flat_vals,
                              new.flat_meta, new.flat_csum, new.ring)
        totals = torch.cat([counts, torch.stack(
            [live.sum(), torch.full((), n_src, device=dev)])])
        dist.all_reduce(totals, op=dist.ReduceOp.SUM, group=self.group)
        moved, evicted, dropped, n_live, n_planned = totals.tolist()
        if dropped:
            raise RuntimeError(f"migration rounds dropped {dropped} rows")
        result = {"n_live": n_live, "n_planned": n_planned, "moved": moved,
                  "evicted_at_dest": evicted, "epoch": new_ring.epoch}
        obs_metrics.inc("migrate.moved", moved)
        obs_metrics.inc("migrate.evicted", evicted)
        obs_trace.record_event("sharded.apply_ring", result)
        return result

    def _record_group_round(self, source: str, es: dict, kind: str,
                            valid: torch.Tensor, t_start: float) -> None:
        """Record one engine round run under the group with the group's
        lanes: its stat lanes and its rows (this rank's ``valid`` ones,
        summed over the ranks).  Makes the reductions only while
        recording is on."""
        if not obs_metrics.enabled():
            return
        red = ReducedStats({**es, _OPS_LANE: valid.sum()}, self.group,
                           self.state.device)
        lanes = red.host_lanes()
        n = lanes.pop(_OPS_LANE)
        obs_trace.record_round(source, lanes, ops={kind: n},
                               t_start=t_start)

    def leave(self, shard_id: int, batch: int = 512) -> dict:
        """Evacuate shard ``shard_id``: its entries move to the ranks that
        own them once it is off the ring."""
        ring = self.ring or ring_create(self.cfg.n_shards)
        return self.apply_ring(ring_leave(ring, shard_id), batch)

    def join(self, shard_id: int, batch: int = 512) -> dict:
        """Bring shard ``shard_id`` back onto the ring: the entries of
        its vnode arcs move in."""
        if self.ring is None:
            raise ValueError("join needs a ring")
        return self.apply_ring(ring_join(self.ring, shard_id), batch)

    # -- crash tolerance ---------------------------------------------------
    def crash(self, shard_id: int, *, wipe: bool = True) -> None:
        """Abrupt death of shard ``shard_id``, on every rank: liveness bit
        down, epoch + 1, placement kept (``membership.ring_crash``) and,
        unless ``wipe=False``, the victim rank's slab zeroed.  Reads fail
        over to the ring successors in the same rounds; with
        ``cfg.n_replicas > 1`` every acked write survives on its other
        copies.  The epoch bump fences every L1 line cached before."""
        if self.ring is None:
            raise ValueError("crash tolerance needs a ring")
        ring = ring_crash(self.ring, shard_id)
        st = self.state
        if wipe and dist.get_rank(self.group) == shard_id:
            wipe_shard(st, 0)
        self.state = DHTState(self.cfg, st.flat_keys, st.flat_vals,
                              st.flat_meta, st.flat_csum, ring)
        obs_metrics.inc("faults.crashes")
        obs_trace.record_event("sharded.crash", {"shard": shard_id,
                                                 "wipe": int(wipe)})

    def recover(self, shard_id: int) -> None:
        """The crashed shard returns (empty) at epoch + 1; :meth:`repair`
        re-converges its replica set."""
        if self.ring is None:
            raise ValueError("crash tolerance needs a ring")
        st = self.state
        self.state = DHTState(self.cfg, st.flat_keys, st.flat_vals,
                              st.flat_meta, st.flat_csum,
                              ring_recover(self.ring, shard_id))
        obs_metrics.inc("faults.recoveries")
        obs_trace.record_event("sharded.recover", {"shard": shard_id})

    def _gather(self, x: torch.Tensor, counts: list) -> torch.Tensor:
        """The ranks' ``x`` rows (rank r holds ``counts[r]``) concatenated
        in rank order, on every rank: one ``all_gather`` of rows padded to
        the largest count."""
        width = max(counts)
        if width == 0:
            return x
        pad = x.new_zeros((width,) + tuple(x.shape[1:]))
        pad[:x.shape[0]] = x
        parts = [torch.empty_like(pad) for _ in counts]
        dist.all_gather(parts, pad, group=self.group)
        return torch.cat([p[:c] for p, c in zip(parts, counts)])

    def _counts(self, n: int) -> list:
        """Every rank's ``n``, in rank order."""
        mine = torch.tensor([n], dtype=torch.int64, device=self.state.device)
        parts = [torch.empty_like(mine) for _ in range(self.cfg.n_shards)]
        dist.all_gather(parts, mine, group=self.group)
        return torch.cat(parts).tolist()

    def _plan_repair(self, shard_id: int):
        """The reference's global repair plan, agreed in lockstep.
        Returns ``(missing, n_candidates, n_present, counts)``: this
        rank's planned source rows (local bucket ids, ascending), the
        group's counts, and every rank's count of planned rows."""
        cfg, st = self.cfg, self.state
        me = dist.get_rank(self.group)
        dev = st.device
        flat = st.flat_keys[:-1]
        h = kops.hash64(flat.contiguous())
        covered = (ring_successors(self.ring, h[:, 0], cfg.n_replicas)
                   == shard_id).any(dim=-1)
        cand = live_mask(st.meta).reshape(-1) & covered
        if me == shard_id:
            cand = torch.zeros_like(cand)
        idx = torch.nonzero(cand).reshape(-1)
        counts = self._counts(idx.shape[0])
        # the group's candidates in flat (rank-major) order: their flat
        # ids and hash words, so every rank finds the same first copies
        g_h64 = self._gather(hash_key64(h[idx]), counts)
        lo = sum(counts[:me])

        def rows_of(pos):
            # each rank hands over its members' key rows, in rank order
            mine = pos[(pos >= lo) & (pos < lo + counts[me])] - lo
            n_mine = self._counts(mine.shape[0])
            return self._gather(flat[idx[mine]], n_mine)

        keep = first_copies(g_h64, rows_of)[lo:lo + counts[me]]
        idx = idx[keep]
        present = self._present(shard_id, flat[idx], h[idx, 1])
        missing = idx[~present]
        totals = torch.stack([torch.full((), idx.shape[0], device=dev),
                              present.sum()]).reshape(2)
        dist.all_reduce(totals, op=dist.ReduceOp.SUM, group=self.group)
        n_candidates, n_present = totals.tolist()
        return (missing, n_candidates, n_present,
                self._counts(missing.shape[0]))

    def _present(self, shard_id: int, keys, h_lo) -> torch.Tensor:
        """Which of this rank's candidate ``keys`` the recovered rank
        holds live in their probe window already: one exchange round to
        it (capacity agreed) and back, one ``probe`` launch there without
        checksum validation."""
        cfg = self.cfg
        dest = torch.full((keys.shape[0],), shard_id, dtype=torch.int32,
                          device=keys.device)
        cap = routing.plan_capacity(dest, cfg.n_shards, group=self.group)
        binned = routing.bin_by_dest(dest, cfg.n_shards, cap)
        base = base_bucket(h_lo, cfg.buckets_per_shard, cfg.n_probe)
        k_in, b_in, m_in = routing.dispatch(
            binned, [keys, base, torch.ones_like(dest)], self.group)
        found = window_present(self.state, k_in.contiguous(),
                               b_in.contiguous())
        (hit,) = routing.collect(binned, [found & (m_in > 0)], self.group)
        return hit & binned.kept

    def repair(self, shard_id: int, batch: int = 512) -> dict:
        """Anti-entropy repair of a recovered shard, in lockstep on every
        rank: the group agrees on the reference's global plan (see the
        module's docstring), then streams the planned copies back in
        get-or-put rounds of ``batch`` rows of the plan (rounded up to a
        multiple of the world size), each pinned to the recovered shard,
        every rank sending its own rows of the slice.  Returns the
        group's ``{n_candidates, n_present, n_planned, healed, skipped,
        rounds, diff_after}``."""
        if self.ring is None:
            raise ValueError("crash tolerance needs a ring")
        if not bool(self.ring.alive[shard_id]):
            raise ValueError("the repair target must be recovered (live) "
                             "first")
        world = self.cfg.n_shards
        me = dist.get_rank(self.group)
        batch = -(-batch // world) * world
        t0 = time.perf_counter()
        missing, n_cand, n_present, counts = self._plan_repair(shard_id)
        n_planned = sum(counts)
        lo_me = sum(counts[:me])
        st = self.state
        tally = torch.zeros(3, dtype=torch.int64, device=st.device)
        rounds = -(-n_planned // batch)
        for r in range(rounds):
            t_b = time.perf_counter()
            # this rank's rows of the plan's slice [r * batch, +batch)
            a = min(max(r * batch - lo_me, 0), counts[me])
            e = min(max((r + 1) * batch - lo_me, 0), counts[me])
            rows = missing[a:e]
            valid = torch.ones(rows.shape[0], dtype=torch.bool,
                               device=st.device)
            got, es = repair_round(st, rows, valid, shard_id, self.group)
            tally += got
            self._record_group_round("sharded.repair", es, "migrate",
                                     valid, t_b)
        dist.all_reduce(tally, op=dist.ReduceOp.SUM, group=self.group)
        dropped, healed, skipped = tally.tolist()
        if dropped:
            raise RuntimeError(f"repair rounds dropped {dropped} rows")
        result = {"n_candidates": n_cand, "n_present": n_present,
                  "n_planned": n_planned, "healed": healed,
                  "skipped": skipped, "rounds": rounds,
                  "diff_after": sum(self._plan_repair(shard_id)[3])}
        obs_metrics.inc("repair.rounds", rounds)
        obs_metrics.inc("repair.keys_healed", healed)
        obs_trace.record_event("sharded.repair_run", result, t_start=t0)
        return result


__all__ = ["ReducedStats", "ShardedDHT", "ShardedRound"]
