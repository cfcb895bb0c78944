"""Surrogate-model cache on top of the DHT (PyTorch port of the exact-match,
pipelined and neighbourhood parts of ``repro.core.surrogate``, paper §5.4).

POET's pattern: round the expensive simulation's inputs to ``sig_digits``
significant digits, pack the rounded vector into the DHT key, store the
exact output as the value.  A later query whose rounded inputs coincide
skips the simulation.  :func:`lookup_or_interpolate` widens the match to
the query's lattice neighbourhood: a near miss resolves by
inverse-distance interpolation over cached neighbours instead of paying
the solver.  :func:`lookup_or_compute_pipelined` issues batch N+1's read
round before computing batch N's misses, so the round runs on the card
while the host computes.

On the card the keys come from the ``round_sig`` kernel and the
neighbourhood's keys from the ``stencil_keys`` kernel
(``kernels/ops.py``); the stencil points are the keys' even words, so the
plain ``stencil_points`` never runs there.

An elastic cache (``surrogate_create(elastic=True)``) places entries on
a consistent-hash ring, so :func:`resize` can grow or shrink it online;
between the begin and the finish of a migration, :func:`lookup` and
:func:`lookup_or_interpolate` take the previous epoch's table as
``prev`` and read both epochs in one round.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels import ops as kops
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from . import dht as dht_ops
from . import interp as interp_ops
from . import membership, migrate, neighbors, routing
from .interp import PROV_MISS, InterpConfig
from .layout import (
    DHTConfig,
    DHTState,
    dht_create,
    pack_floats,
    unpack_floats,
)
from .op_engine import (
    OP_MIGRATE,
    OP_READ,
    W_DROPPED,
    W_INSERT,
    dht_execute,
    migrate_ops,
    mixed_ops,
)
from .pipeline import PendingWrites, RoundQueue


@dataclasses.dataclass(frozen=True)
class SurrogateConfig:
    n_inputs: int = 10        # POET: 9 species + time step
    n_outputs: int = 13       # POET: 13 result values
    sig_digits: int = 4       # key rounding (accuracy/hit-rate trade-off)
    dht: DHTConfig = dataclasses.field(default_factory=DHTConfig)

    def __post_init__(self):
        if self.dht.key_words < 2 * self.n_inputs:
            raise ValueError("key_words too small for n_inputs")
        if self.dht.val_words < 2 * self.n_outputs:
            raise ValueError("val_words too small for n_outputs")


def surrogate_create(cfg: SurrogateConfig, *, elastic: bool = False,
                     n_virtual: int = 64,
                     device: str | torch.device | None = None) -> DHTState:
    """The empty cache on ``device`` (CUDA unless the caller asks for
    another).  ``elastic=True`` places entries on a consistent-hash ring
    of ``n_virtual`` vnodes a shard, so the cache can be resized online
    (:func:`resize`)."""
    ring = (membership.ring_create(cfg.dht.n_shards, n_virtual)
            if elastic else None)
    return dht_create(cfg.dht, ring, device=device)


def resize(cfg: SurrogateConfig, state: DHTState, new_n_shards: int, *,
           batch: int = migrate.DEFAULT_BATCH
           ) -> tuple[SurrogateConfig, DHTState, dict]:
    """Grow or shrink the cache online; cached results survive the move.
    POET's occupancy climbs over a run, so resizing before evictions
    start destroying hits is the elastic workload.  Returns ``(cfg',
    state', stats)``; ``state`` is freed (``migrate.migration_finish``)."""
    state, stats = migrate.dht_resize(state, new_n_shards, batch=batch)
    return dataclasses.replace(cfg, dht=state.cfg), state, stats


def make_keys(cfg: SurrogateConfig, inputs: torch.Tensor) -> torch.Tensor:
    """(n, n_inputs) float -> (n, KW) int32 rounded keys (80 B for POET)."""
    return pack_floats(kops.round_sig(inputs, cfg.sig_digits),
                       cfg.dht.key_words)


def lookup(cfg: SurrogateConfig, state: DHTState, inputs: torch.Tensor, *,
           prev: DHTState | None = None, axis_name=None):
    """Query the cache.  Returns ``(state', outputs, found, stats)``.
    ``prev`` (the previous-epoch table of an in-flight migration) takes
    the dual-epoch read, so entries still moving stay visible."""
    keys = make_keys(cfg, inputs)
    if prev is None:
        state, val_words, found, stats = dht_ops.dht_read(
            state, keys, axis_name=axis_name)
    else:
        state, _prev, val_words, found, stats = dht_ops.dht_read_dual(
            state, prev, keys, axis_name=axis_name)
    return state, unpack_floats(val_words, cfg.n_outputs), found, stats


def lookup_cached(cfg: SurrogateConfig, state: DHTState, l1, inputs, *,
                  axis_name=None):
    """:func:`lookup` through the locality tier: POET's grid cells
    re-query near-identical chemistry, so the rounded keys repeat and the
    L1 cache (``core/l1cache.py``) serves the hot ones without a routing
    round.  Returns ``(state', l1', outputs, found, stats)``, the outputs
    bit for bit :func:`lookup`'s; ``l1`` is updated in place."""
    state, l1, val_words, found, stats = dht_ops.dht_read_cached(
        state, l1, make_keys(cfg, inputs), axis_name=axis_name)
    return state, l1, unpack_floats(val_words, cfg.n_outputs), found, stats


def store(cfg: SurrogateConfig, state: DHTState, inputs: torch.Tensor,
          outputs: torch.Tensor, valid=None, *, axis_name=None):
    keys = make_keys(cfg, inputs)
    vals = pack_floats(outputs, cfg.dht.val_words)
    return dht_ops.dht_write(state, keys, vals, valid, axis_name=axis_name)


def lookup_or_compute(cfg: SurrogateConfig, state: DHTState,
                      inputs: torch.Tensor, compute_fn, *,
                      one_round: bool = False, axis_name=None):
    """The surrogate pattern: hit -> reuse; miss -> compute and publish.

    ``compute_fn(inputs) -> outputs`` is the expensive simulation.

    Host form (default): a read round first; a full-hit batch returns
    without calling ``compute_fn``, otherwise the misses are computed
    and written back in a second round.

    ``one_round=True``: ``compute_fn`` runs on every row and the lookup
    and write-back ride ONE get-or-put round (``OP_MIGRATE``): present
    keys return their stored value, absent keys publish the computed
    one.  This is the form the reference takes under tracing, and the
    only one under a process group (``axis_name``): the host form's
    full-hit short cut is decided per rank, so ranks would issue
    different numbers of exchanges.  The stats are then the rank's."""
    if not one_round and axis_name is None:
        state, cached, found, rstats = lookup(cfg, state, inputs)
        stats = {"hits": rstats["hits"], "misses": rstats["misses"],
                 "mismatches": rstats["mismatches"], "stored": 0}
        if bool(found.all()):
            _record_provenance(stats)
            return state, cached, found, stats
        computed = compute_fn(inputs)
        outputs = torch.where(found[:, None], cached, computed)
        state, wstats = store(cfg, state, inputs, computed, valid=~found)
        stats["stored"] = wstats["inserted"]
        _record_provenance(stats)
        return state, outputs, found, stats

    keys = make_keys(cfg, inputs)
    computed = compute_fn(inputs)
    vals = pack_floats(computed, cfg.dht.val_words)
    state, _, val_words, found, code, es = dht_execute(
        state, migrate_ops(keys, vals), kinds=("migrate",),
        axis_name=axis_name)
    cached = unpack_floats(val_words, cfg.n_outputs)
    outputs = torch.where(found[:, None], cached, computed)
    stats = {
        "hits": found.sum().to(torch.int32),
        "misses": (~found).sum().to(torch.int32),
        "mismatches": es["mismatches"],
        "stored": (code == W_INSERT).sum().to(torch.int32),
    }
    return state, outputs, found, stats


def lookup_or_compute_pipelined(cfg: SurrogateConfig, state: DHTState,
                                batches, compute_fn, *, depth: int = 2):
    """Pipelined surrogate driver: probe batch N+1 while computing the
    misses of batch N.

    :func:`lookup_or_compute` serializes ``read -> compute -> write`` per
    batch.  Here batch N+1's read round is *issued* (``dht_read_async``)
    before batch N's ``compute_fn`` runs, so the card works through the
    round while the host computes, and it is committed only when its
    results are needed.

    Hazard rule (the store buffer, :class:`core.pipeline.PendingWrites`):
    batch N+1's read is issued before batch N's write-back, so any of its
    keys that batch N is about to write would probe a stale table.  Those
    keys are promised at miss time, before the next read is issued; the
    read masks them out of its probe and serves them at commit by
    forwarding the published values, which makes the result bit for bit
    the sequential schedule's.  The promises are retired only after the
    following read's commit.  Reading further ahead would need batch
    N+1's miss set before its commit, so ``depth < 2`` falls back to the
    synchronous loop and ``depth >= 2`` pipelines one read ahead with a
    depth-``depth`` queue of lazily committed write rounds.  Rows a write
    round dropped on a routing overflow are re-issued at its commit, at
    most twice (``requeued``).

    ``batches`` is a sequence of ``(n_i, n_inputs)`` input tensors.
    Returns ``(state', outputs, found, stats)`` with per-batch lists of
    ``outputs``/``found`` and summed int ``stats``: ``hits``, ``misses``,
    ``stored``, ``forwarded`` (rows served by forwarding) and
    ``requeued``."""
    batches = list(batches)
    totals = {"hits": 0, "misses": 0, "stored": 0, "forwarded": 0,
              "requeued": 0}
    outs: list = []
    founds: list = []
    if not batches:
        _record_provenance(totals)
        return state, outs, founds, totals
    if depth < 2:
        for inputs in batches:
            state, out, found, st = lookup_or_compute(cfg, state, inputs,
                                                      compute_fn)
            outs.append(out)
            founds.append(found)
            for k in ("hits", "misses", "stored"):
                totals[k] += int(st[k])
        # lookup_or_compute recorded each batch's provenance already
        return state, outs, founds, totals

    pending = PendingWrites(cfg.dht.val_words)

    def _commit_write(w):
        """Commit one write-back round and re-issue the rows the router
        dropped on overflow (at most twice): a dropped insert is a lost
        entry that the next epoch would recompute."""
        _, wstats = dht_ops.dht_write_commit(w)
        totals["stored"] += int(wstats["inserted"])
        drop = w.meta["wmask"] & (wstats["code"] == W_DROPPED)
        tries = 0
        while tries < 2 and bool(drop.any()):
            totals["requeued"] += int(drop.sum())
            _, rstats = dht_ops.dht_write(state, w.meta["wkeys"],
                                          w.meta["wvals"], valid=drop)
            totals["stored"] += int(rstats["inserted"])
            drop = drop & (rstats["code"] == W_DROPPED)
            tries += 1
        return wstats

    wq = RoundQueue(depth, commit=_commit_write)

    def _issue_read(inputs):
        keys = make_keys(cfg, inputs)
        rnd = dht_ops.dht_read_async(state, keys, pending=pending)
        rnd.meta["skeys"] = keys
        return rnd

    rd = _issue_read(batches[0])
    to_retire = None
    for i, inputs in enumerate(batches):
        keys = rd.meta["skeys"]
        conflict = rd.conflict
        _, val_words, found, rstats = dht_ops.dht_read_commit(rd)
        if to_retire is not None:
            # the previous batch's write round is issued AND the one read
            # that could still forward from it has committed: only now may
            # its promises go (resolve needed the published values)
            pending.retire(*to_retire)
            to_retire = None
        miss = ~found
        counts = [rstats["hits"], rstats["misses"]]
        if conflict is not None:
            counts.append(conflict.sum())
        counts = torch.stack([c.to(torch.int64) for c in counts]).tolist()
        totals["hits"] += counts[0]
        totals["misses"] += counts[1]
        totals["forwarded"] += counts[2] if conflict is not None else 0
        any_miss = counts[1] > 0
        if any_miss:
            # promise BEFORE issuing the next read: its conflict filter
            # must know the keys this batch is about to write
            pending.promise(keys, miss)
        nxt = _issue_read(batches[i + 1]) if i + 1 < len(batches) else None
        if any_miss:
            # the expensive part: overlaps nxt's round on the card
            computed = compute_fn(inputs)
            outputs = torch.where(found[:, None],
                                  unpack_floats(val_words, cfg.n_outputs),
                                  computed)
            wvals = pack_floats(computed, cfg.dht.val_words)
            pending.publish(keys, wvals, miss)
            w = dht_ops.dht_write_async(state, keys, wvals, valid=miss)
            w.meta.update(wkeys=keys, wvals=wvals, wmask=miss)
            # the stream orders every read issued from here on after this
            # write; the read already issued may still forward from it,
            # so its promises retire after that read's commit
            to_retire = (keys, miss)
            wq.push(w)
        else:
            outputs = unpack_floats(val_words, cfg.n_outputs)
        outs.append(outputs)
        founds.append(found)
        rd = nxt
    wq.drain()
    _record_provenance(totals)
    return state, outs, founds, totals


# ---------------------------------------------------------------------------
# neighbourhood queries
# ---------------------------------------------------------------------------

def _stencil(cfg: SurrogateConfig, inputs: torch.Tensor, icfg: InterpConfig):
    """Stencil keys (n, M, KW) from the kernel switch, and the points
    (n, M, D) read back from the keys' even words (bit for bit the
    points the keys were packed from)."""
    keys, _base = kops.stencil_keys(
        inputs, cfg.sig_digits, cfg.dht.key_words, icfg.radius,
        icfg.coarse_tier, cfg.dht.buckets_per_shard, cfg.dht.n_probe)
    return keys, unpack_floats(keys, inputs.shape[-1])


def _interp_tail(cfg: SurrogateConfig, inputs, points, val_words, found,
                 icfg: InterpConfig, valid, probe_hits, transport_stats):
    """Shared post-probe half of the neighbourhood query: unpack the
    stencil replies, take the lattice step at the centre, run the gated
    IDW blend and assemble the stats."""
    values = unpack_floats(val_words, cfg.n_outputs)        # (n, M, O)
    step = neighbors.lattice_step(points[:, 0], cfg.sig_digits)
    outputs, provenance, istats = interp_ops.interpolate(
        inputs, points, values, found, step, icfg)
    wire = obs_metrics.merge_wire_stats(transport_stats)
    stats = {
        "exact": istats["exact"],
        "interpolated": istats["interpolated"],
        "misses": (valid & (provenance == PROV_MISS)).sum().to(torch.int32),
        "neighbors_mean": istats["neighbors_mean"],
        "probe_hits": probe_hits,
        "mismatches": transport_stats["mismatches"],
        "dropped": transport_stats["dropped"],
        "epoch": transport_stats["epoch"],
        "wire_words": wire["wire_words"],
        "fill_frac": wire["fill_frac"],
    }
    return outputs, provenance, stats


# provenance lanes the lookup_* host paths flush to the counters
_PROV_LANES = ("exact", "interpolated", "hits", "misses", "stored",
               "probe_hits", "requeued")


def _record_provenance(stats: dict) -> None:
    """Add the provenance lanes ``stats`` has to the ``surrogate.<lane>``
    counters, reading them back to the host in one copy.  Nothing is
    read while recording is off."""
    if not obs_metrics.enabled():
        return
    lanes = obs_trace._scalarize({lane: stats[lane] for lane in _PROV_LANES
                                  if stats.get(lane) is not None})
    for lane, v in lanes.items():
        obs_metrics.inc(f"surrogate.{lane}", v)


def lookup_or_interpolate(cfg: SurrogateConfig, state: DHTState,
                          inputs: torch.Tensor,
                          icfg: InterpConfig = InterpConfig(), *,
                          valid: torch.Tensor | None = None, prev=None,
                          axis_name=None):
    """Neighbourhood query: exact hit -> cached value; near miss -> IDW
    interpolation over cached lattice neighbours; else miss.

    Enumerates the +-``icfg.radius`` stencil around each query's rounded
    key (plus the optional coarse tier), probes all stencil keys in ONE
    routing round (:func:`dht_read_many`; both epochs in that one round
    through :func:`dht_read_many_dual` when ``prev``, the previous-epoch
    table of an in-flight migration, is given) and gates the blend on
    ``icfg.max_neighbor_dist``/``icfg.min_neighbors``.  ``valid`` masks
    whole rows: they probe nothing and report ``PROV_MISS``.

    Returns ``(state', outputs (n, n_outputs), provenance (n,), stats)``,
    or with ``prev`` ``(state', prev', outputs, provenance, stats)``."""
    keys, points = _stencil(cfg, inputs, icfg)
    vmask = neighbors.dedup_mask(keys)
    if valid is None:
        valid = torch.ones(inputs.shape[0], dtype=torch.bool,
                           device=inputs.device)
    vmask = vmask & valid[:, None]
    if prev is None:
        state, val_words, found, rstats = dht_ops.dht_read_many(
            state, keys, vmask, axis_name=axis_name)
    else:
        state, prev, val_words, found, rstats = dht_ops.dht_read_many_dual(
            state, prev, keys, vmask, axis_name=axis_name)
    outputs, provenance, stats = _interp_tail(
        cfg, inputs, points, val_words, found, icfg, valid,
        probe_hits=rstats["hits"], transport_stats=rstats)
    _record_provenance(stats)
    if prev is None:
        return state, outputs, provenance, stats
    return state, prev, outputs, provenance, stats


def lookup_interpolate_or_compute(cfg: SurrogateConfig, state: DHTState,
                                  inputs: torch.Tensor, compute_fn,
                                  icfg: InterpConfig = InterpConfig(), *,
                                  one_round: bool = False, axis_name=None):
    """:func:`lookup_or_compute` with the neighbourhood fast path: only
    rows neither cached nor interpolable pay ``compute_fn``; computed
    (exact) outputs are published, interpolated values never are.

    Host form (default): the probe round first; a batch with no
    ``PROV_MISS`` row skips ``compute_fn``, and only the misses are
    written back in a second round.

    ``one_round=True`` (the reference's traced form): ``compute_fn`` runs
    on every row, and the n*M stencil reads and the n centre-key
    write-backs ride ONE mixed ``OP_READ`` + ``OP_MIGRATE`` engine round:
    every row whose exact key was absent publishes its computed output
    (misses and interpolated rows alike), present keys are skipped.  A
    process group (``axis_name``) always takes this form, as in the
    reference: the host form's short cut is decided per rank."""
    if not one_round and axis_name is None:
        state, resolved, provenance, stats = lookup_or_interpolate(
            cfg, state, inputs, icfg, axis_name=axis_name)
        miss = provenance == PROV_MISS
        if not bool(miss.any()):
            obs_metrics.inc("surrogate.stored", 0)
            return state, resolved, provenance, {
                **stats, "stored": torch.zeros((), dtype=torch.int32,
                                               device=inputs.device)}
        computed = compute_fn(inputs)
        outputs = torch.where(miss[:, None], computed, resolved)
        state, wstats = store(cfg, state, inputs, computed, valid=miss)
        if obs_metrics.enabled():
            obs_metrics.inc("surrogate.stored", int(wstats["inserted"]))
        return state, outputs, provenance, {**stats,
                                            "stored": wstats["inserted"]}

    computed = compute_fn(inputs)
    keys, points = _stencil(cfg, inputs, icfg)
    n, m = keys.shape[0], keys.shape[1]
    vmask = neighbors.dedup_mask(keys)
    flat, vflat = routing.flatten_fanout(keys, vmask)
    center = keys[:, 0]
    cvals = pack_floats(computed, cfg.dht.val_words)
    nm = n * m
    dev = keys.device
    op = torch.cat([torch.full((nm,), OP_READ, dtype=torch.int32, device=dev),
                    torch.full((n,), OP_MIGRATE, dtype=torch.int32,
                               device=dev)])
    ops = mixed_ops(
        op, torch.cat([flat, center]),
        torch.cat([torch.zeros((nm, cvals.shape[1]), dtype=torch.int32,
                               device=dev), cvals]),
        valid=torch.cat([vflat, torch.ones(n, dtype=torch.bool, device=dev)]))
    state, _, val_flat, found_flat, code, es = dht_execute(
        state, ops, kinds=("read", "migrate"), axis_name=axis_name)
    val_words = routing.unflatten_fanout(val_flat[:nm], n, m)
    found = routing.unflatten_fanout(found_flat[:nm], n, m)
    resolved, provenance, stats = _interp_tail(
        cfg, inputs, points, val_words, found, icfg,
        valid=torch.ones(n, dtype=torch.bool, device=dev),
        probe_hits=found.sum().to(torch.int32), transport_stats=es)
    miss = provenance == PROV_MISS
    outputs = torch.where(miss[:, None], computed, resolved)
    stats["stored"] = (code[nm:] == W_INSERT).sum().to(torch.int32)
    return state, outputs, provenance, stats
