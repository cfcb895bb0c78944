"""Rank bodies of tests/test_torch_distributed.py (and, for the ``faults``
group, tests/test_torch_faults.py): one process per rank of a gloo group
on the CPU, running the port's multi-rank backend
(``repro_torch.core.distributed``) on seeded inputs and saving what it
saw to ``<out>/<group>_rank<r>.npz``.

    python tests/torch_dist_ranks.py GROUP RANK WORLD PORT OUT

Importing this module loads numpy only (the input makers below are
shared with the test and the reference's subprocess); each rank body
imports torch and ``repro_torch``, never JAX or ``repro``.
"""
from __future__ import annotations

import datetime
import sys

import numpy as np

KW, VW = 20, 26
WORLD = 2
MODES = ("lockfree", "fine", "coarse")
N = 256                 # the group's batch: N // WORLD rows a rank
CAP = 64                # the capacity>0 cases: drops happen at this size
RETRY_N, RETRY_CAP = 128, 24
TIER_CAP = N // WORLD   # above every (source, destination) bin: no drops
SURR_N = 96
# bucket counts: the modes streams, the L1/pipeline streams, the surrogate
BUCKETS = 512
TIER_BUCKETS = 1024
# the elastic group: 3 ranks, so a leaver's entries fan out to two
ELASTIC_WORLD = 3
ELASTIC_N = 192         # the group's keys, 64 a rank
ELASTIC_BUCKETS = 512
ELASTIC_BATCH = 96      # the group's rows a migrate round, 32 a rank
# the faults group (tests/test_torch_faults.py): 4 ranks, k = 2
FAULT_WORLD = 4
FAULT_BUCKETS = 4096
FAULT_N = 256           # the group's batch: 64 rows a rank
FAULT_CAP = 64          # per (source, destination) pair: nothing drops
FAULT_VICTIM = 1
FAULT_BATCH = 64        # the group's rows a repair round
FAULT_RETRY_CAP = 48    # single device: below the bins of 256 rows
FAULT_SHARDED_RETRY_CAP = 8     # a pair's bins hold ~16 rows (k=1)


def words(rng, n: int, w: int) -> np.ndarray:
    return rng.integers(0, 2**31, size=(n, w)).astype(np.uint32)


def mode_inputs(seed: int = 5) -> dict:
    """The modes streams: a write batch, a get-or-put batch half present
    half fresh (``mk``/``mv``) and a 95/5 read/write tag."""
    rng = np.random.default_rng(seed)
    keys, vals = words(rng, N, KW), words(rng, N, VW)
    k2, v2 = words(rng, N, KW), words(rng, N, VW)
    mk = np.concatenate([keys[:N // 2], k2[:N // 2]])
    mv = np.concatenate([vals[:N // 2] + 3, v2[:N // 2]])
    op = (rng.random(N) < 0.05).astype(np.int32)
    return {"keys": keys, "vals": vals, "mk": mk, "mv": mv, "op": op}


def retry_inputs(seed: int = 2) -> dict:
    rng = np.random.default_rng(seed)
    return {"keys": words(rng, RETRY_N, KW), "vals": words(rng, RETRY_N, VW)}


def pipe_batches(seed: int = 1) -> list:
    """The pipelined schedule's 4 batches of 96 keys, a third of each
    repeating the previous batch (tests/test_pipeline.py's stream)."""
    rng = np.random.default_rng(seed)
    out, prev = [], None
    for _ in range(4):
        ids = rng.integers(0, 4000, size=96)
        if prev is not None:
            ids[:32] = prev[rng.integers(0, 96, size=32)]
        prev = ids
        kb = np.zeros((96, KW), np.uint32)
        kb[:, 0] = ids
        kb[:, 1] = ids * 7 + 1
        out.append(kb)
    return out


def pipe_compute(keys: np.ndarray) -> np.ndarray:
    x = keys[:, :4].astype(np.float64)
    return ((x * 2654435761.0) % 2**31).astype(np.uint32).repeat(
        VW // 4 + 1, axis=1)[:, :VW]


def surrogate_inputs(seed: int = 11) -> list:
    """Two batches of POET-shaped inputs on the sig-3 lattice: the
    neighbours one step either side (along dim 0) of SURR_N // 2
    centres, then the centres themselves (two cached neighbours each:
    interpolated) beside the first batch's rows perturbed below the
    rounding (exact hits)."""
    rng = np.random.default_rng(seed)
    c = np.round(rng.uniform(1.5, 8.5, size=(SURR_N // 2, 10)), 2)
    lo, hi = c.copy(), c.copy()
    lo[:, 0] -= 0.01
    hi[:, 0] += 0.01
    x1 = np.concatenate([lo, hi]).astype(np.float32)
    x2 = np.concatenate([c.astype(np.float32),
                         (x1[::2] * np.float32(1 + 1e-6))]).astype(
        np.float32)
    return [x1, x2]


def elastic_inputs(seed: int = 7) -> dict:
    rng = np.random.default_rng(seed)
    return {"keys": words(rng, ELASTIC_N, KW),
            "vals": words(rng, ELASTIC_N, VW)}


def kv(n: int, seed: int):
    """Keys with values a pure function of the key (tests/test_faults.py's
    ``_kv``): a duplicate write is idempotent and a read is checkable."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**31, size=(n, KW), dtype=np.int64)
    vals = np.zeros((n, VW), np.uint32)
    for w in range(VW):
        vals[:, w] = (keys[:, 0] * (2 * w + 1) * 2654435761 + w) & 0xFFFFFFFF
    return keys.astype(np.uint32), vals


def fault_inputs() -> dict:
    """The crash sequence's batches: written before and during the
    outage."""
    k1, v1 = kv(FAULT_N, 4)
    k2, v2 = kv(FAULT_N, 6)
    return {"k1": k1, "v1": v1, "k2": k2, "v2": v2}


def block(a: np.ndarray, rank: int, world: int = WORLD) -> np.ndarray:
    """Rank ``rank``'s rows of the group's batch."""
    n = a.shape[0] // world
    return a[rank * n:(rank + 1) * n]


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------

class _Out(dict):
    def put(self, prefix: str, value) -> None:
        import torch

        if isinstance(value, dict):
            for k, v in value.items():
                self.put(f"{prefix}/{k}", v)
        elif torch.is_tensor(value):
            # a copy: the port updates tables in place
            v = value.detach().cpu().numpy().copy()
            self[prefix] = (v.view(np.uint32)
                            if v.dtype == np.int32 and v.ndim > 1 else v)
        else:
            self[prefix] = np.array(value)

    def slab(self, prefix: str, state) -> None:
        from repro_torch.convert import state_to_numpy

        for k, v in state_to_numpy(state).items():
            self[f"{prefix}/{k}"] = v.copy()


def _t(a: np.ndarray):
    import torch

    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def group_modes(rank: int, out: _Out) -> None:
    """All three modes: the wrappers and the engine closures at capacity
    CAP (held against the reference's ShardedDHT, drops included), the
    same stream at capacity 0 (held against the virtual-shard backend),
    read_many with and without a mask, and the write retry."""
    import torch

    from repro_torch.core import DHTConfig, mixed_ops
    from repro_torch.core import dht_execute
    from repro_torch.core.distributed import ShardedDHT

    inp = {k: _t(block(v, rank)) for k, v in mode_inputs().items()}
    keys, vals, mk, mv = inp["keys"], inp["vals"], inp["mk"], inp["mv"]
    n = keys.shape[0]
    ones = torch.ones(n, dtype=torch.bool)
    many = keys.reshape(n // 4, 4, KW)
    first = torch.zeros((n // 4, 4), dtype=torch.bool)
    first[:, 0] = True
    for mode in MODES:
        for cap in (CAP, 0):
            p = f"{mode}/cap{cap}"
            cfg = DHTConfig(n_shards=WORLD, buckets_per_shard=BUCKETS,
                            mode=mode, capacity=cap)
            a = ShardedDHT.create(cfg, device="cpu")
            out.put(f"{p}/write", a.write(keys, vals))
            o, f, s = a.read(keys)
            out.put(f"{p}/read", {"out": o, "found": f, "stats": s})
            o, f, s = a.read_many(many)
            out.put(f"{p}/many", {"out": o, "found": f, "stats": s})
            o, f, s = a.read_many(many, first)
            out.put(f"{p}/many_first", {"out": o, "found": f, "stats": s})
            em = a.execute_fn(("migrate",))
            a.state, o, f, c, es = em(a.state, mk, mv, ones)
            out.put(f"{p}/migrate", {"out": o, "found": f, "code": c,
                                     "stats": es})
            out.slab(f"{p}/a_slab", a.state)
            # the engine closures on a second table
            b = ShardedDHT.create(cfg, device="cpu")
            ew, er = b.execute_fn(("write",)), b.execute_fn(("read",))
            b.state, _, _, c, es = ew(b.state, keys, vals, ones)
            out.put(f"{p}/ex_write", {"code": c, "stats": es})
            b.state, o, f, _, es = er(b.state, keys, vals, ones)
            out.put(f"{p}/ex_read", {"out": o, "found": f, "stats": es})
            out.slab(f"{p}/b_slab", b.state)
            if cap == 0:
                # a 95/5 mixed round through the engine on the group
                b.state, _, o, f, c, es = dht_execute(
                    b.state, mixed_ops(inp["op"], mk, mv),
                    kinds=("read", "write"), axis_name=b.group)
                out.put(f"{p}/mixed", {"out": o, "found": f, "code": c})
                out.slab(f"{p}/mixed_slab", b.state)
    r = {k: _t(block(v, rank)) for k, v in retry_inputs().items()}
    d = ShardedDHT.create(DHTConfig(n_shards=WORLD, buckets_per_shard=4096,
                                    capacity=RETRY_CAP), device="cpu")
    out.put("retry/write", d.write(r["keys"], r["vals"]))
    out.slab("retry/slab", d.state)


def group_tier(rank: int, out: _Out) -> None:
    """The locality tier with self-traffic elision, the elision's wire
    accounting, the issue/commit wrappers, the pipelined schedule with L1
    on and off, and the two surrogate forms through the group."""
    import torch

    from repro_torch.core import (DHTConfig, InterpConfig, L1Config,
                                  PendingWrites, SurrogateConfig,
                                  dht_execute, lookup_interpolate_or_compute,
                                  lookup_or_compute, read_ops)
    from repro_torch.core.distributed import ShardedDHT

    inp = {k: _t(block(v, rank)) for k, v in mode_inputs(7).items()}
    keys, vals = inp["keys"], inp["vals"]
    n = keys.shape[0]
    cfg = DHTConfig(n_shards=WORLD, buckets_per_shard=TIER_BUCKETS,
                    capacity=TIER_CAP)
    a = ShardedDHT.create(cfg, device="cpu")
    b = ShardedDHT.create(cfg, device="cpu",
                          l1cfg=L1Config(n_sets=64, n_ways=4))
    a.write(keys, vals)
    b.write(keys, vals)
    o1, f1, s1 = a.read(keys)
    out.put("l1/plain1", {"out": o1, "found": f1, "stats": s1})
    # the same read with the exchange not elided: one more block a leg
    _, _, o, f, _, es = dht_execute(a.state, read_ops(keys),
                                    kinds=("read",), axis_name=a.group,
                                    elide_self=False)
    out.put("l1/routed", {"out": o, "found": f, "wire_words":
                          es["wire_words"]})
    _, _, _, _, _, es = dht_execute(a.state, read_ops(keys),
                                    kinds=("read",), axis_name=a.group)
    out.put("l1/elided", {"wire_words": es["wire_words"]})
    for i in (2, 3):
        o, f, s = b.read(keys)
        out.put(f"l1/cached{i}", {"out": o, "found": f, "stats": s})
    q = n // 4
    a.write(keys[:q], vals[:q] + 9)
    b.write(keys[:q], vals[:q] + 9)
    o, f, s = b.read(keys)
    out.put("l1/cached4", {"out": o, "found": f, "stats": s})
    o, f, s = a.read(keys)
    out.put("l1/plain4", {"out": o, "found": f, "stats": s})
    many = keys.reshape(n // 4, 4, KW)
    for name, d in (("plain", a), ("cached", b)):
        o, f, _ = d.read_many(many)
        out.put(f"l1/{name}_many", {"out": o, "found": f})
        out.slab(f"l1/{name}_slab", d.state)

    # the issue/commit wrappers against the sync ones, depth flipped
    for name, d in (("plain", a), ("cached", b)):
        o_s, f_s, _ = d.read(keys)
        o_a, f_a, st_a = d.read_commit(d.read_async(keys))
        d.pipeline_depth = 3
        o_b, f_b, _ = d.read_commit(d.read_async(keys))
        out.put(f"async/{name}", {
            "sync": o_s, "found_sync": f_s, "async": o_a, "found": f_a,
            "depth3": o_b, "found3": f_b, "overlap": st_a["overlap_frac"]})
        ws = d.write_commit(d.write_async(keys, vals))
        out.put(f"async/{name}_write", ws)
        wq = d.round_queue()
        done = [wq.push(d.write_async(keys[i::3], vals[i::3] + i))
                for i in range(3)]
        done = [r for r in done if r is not None] + wq.drain()
        out.put(f"async/{name}_queue", {
            "updated": [int(r[-1]["updated"]) for r in done]})
        out.slab(f"async/{name}_slab", d.state)

    # the pipelined schedule against the synchronous one, L1 off and on.
    # The store buffer must hold the GROUP's promises (a row may repeat a
    # key another rank is about to write): every rank feeds it the whole
    # batch, with the miss masks gathered from all ranks.
    import torch.distributed as dist

    glob = [_t(kb) for kb in pipe_batches()]
    batches = [block(kb, rank) for kb in glob]
    pcfg = DHTConfig(n_shards=WORLD, buckets_per_shard=TIER_BUCKETS)

    def gathered(mask):
        parts = [torch.empty_like(mask) for _ in range(WORLD)]
        dist.all_gather(parts, mask)
        return torch.cat(parts)

    def compute(kb):
        return _t(pipe_compute(kb.numpy().view(np.uint32)))

    for l1cfg in (None, L1Config(n_sets=64, n_ways=4)):
        tag = "l1" if l1cfg else "nol1"
        d = ShardedDHT.create(pcfg, device="cpu", l1cfg=l1cfg)
        outs_s = []
        for kb in batches:
            v, f, _ = d.read(kb)
            miss = ~f
            cv = compute(kb)
            outs_s.append((torch.where(miss[:, None], cv, v), f))
            d.write(kb, cv, miss)
        d = ShardedDHT.create(pcfg, device="cpu", l1cfg=l1cfg)
        pending = PendingWrites(VW)
        wq = d.round_queue(d.write_commit)
        outs_p = []
        conf = block(pending.conflicts(glob[0]), rank)
        rd = d.read_async(batches[0], ~conf)
        to_retire = None
        for i, kb in enumerate(batches):
            v, f, _ = d.read_commit(rd)
            if bool(conf.any()):
                fv = pending.resolve(kb, conf)
                v = torch.where(conf[:, None], fv, v)
                f = f | conf
            if to_retire is not None:
                pending.retire(*to_retire)
                to_retire = None
            miss = ~f
            gmiss = gathered(miss)
            pending.promise(glob[i], gmiss)
            if i + 1 < len(batches):
                nconf = block(pending.conflicts(glob[i + 1]), rank)
                nrd = d.read_async(batches[i + 1], ~nconf)
            cv = compute(kb)
            outs_p.append((torch.where(miss[:, None], cv, v), f))
            pending.publish(glob[i], compute(glob[i]), gmiss)
            wq.push(d.write_async(kb, cv, miss))
            to_retire = (glob[i], gmiss)
            if i + 1 < len(batches):
                rd, conf = nrd, nconf
        wq.drain()
        for i, ((o_s, f_s), (o_p, f_p)) in enumerate(zip(outs_s, outs_p)):
            out.put(f"pipe/{tag}/{i}", {"out_s": o_s, "found_s": f_s,
                                        "out_p": o_p, "found_p": f_p})

    # the two surrogate forms through the group (one round each)
    scfg = SurrogateConfig(n_inputs=10, n_outputs=13, sig_digits=3,
                           dht=DHTConfig(n_shards=WORLD,
                                         buckets_per_shard=TIER_BUCKETS))

    def solve(x):
        return torch.cat([x * 2.0, x[:, :3]], dim=-1)

    xs = [torch.from_numpy(block(x, rank)) for x in surrogate_inputs()]
    d = ShardedDHT.create(scfg.dht, device="cpu")
    for i, x in enumerate(xs):
        d.state, o, f, s = lookup_or_compute(scfg, d.state, x, solve,
                                             axis_name=d.group)
        out.put(f"surr/loc{i}", {"out": o, "found": f, "stats": s})
    out.slab("surr/loc_slab", d.state)
    d = ShardedDHT.create(scfg.dht, device="cpu")
    for i, x in enumerate(xs):
        d.state, o, prov, s = lookup_interpolate_or_compute(
            scfg, d.state, x, solve, InterpConfig(), one_round=True,
            axis_name=d.group)
        out.put(f"surr/lic{i}", {"out": o, "prov": prov,
                                 "stored": s["stored"]})
    out.slab("surr/lic_slab", d.state)


def group_elastic(rank: int, out: _Out) -> None:
    """Elastic membership on 3 ranks: a table on a ring takes the group's
    batch, shard 1 leaves (its entries fan out to ranks 0 and 2) and joins
    again through the lockstep ``apply_ring``; each rank reads its rows
    after each change.  Rank 0 also runs the virtual-shard backend's
    ``shard_leave``/``shard_join`` on the same batch."""
    from repro_torch.core import (DHTConfig, dht_create, dht_read,
                                  dht_write, ring_create, shard_join,
                                  shard_leave)
    from repro_torch.core.distributed import ShardedDHT

    world = ELASTIC_WORLD
    inp = elastic_inputs()
    keys, vals = (_t(block(inp[k], rank, world)) for k in ("keys", "vals"))
    cfg = DHTConfig(n_shards=world, buckets_per_shard=ELASTIC_BUCKETS)
    d = ShardedDHT.create(cfg, device="cpu", ring=ring_create(world))
    out.put("write", d.write(keys, vals))
    out.slab("init", d.state)
    for step, change in (("leave", d.leave), ("join", d.join)):
        out.put(f"{step}/stats", change(1, batch=ELASTIC_BATCH))
        o, f, s = d.read(keys)
        out.put(f"{step}/read", {"out": o, "found": f,
                                 "epoch": s["epoch"]})
        out.slab(f"{step}/slab", d.state)
    if rank:
        return
    st = dht_create(cfg, ring_create(world), device="cpu")
    dht_write(st, _t(inp["keys"]), _t(inp["vals"]))
    out.slab("virtual/init", st)
    for step, change in (("leave", shard_leave), ("join", shard_join)):
        st, stats = change(st, 1, batch=ELASTIC_BATCH)
        out.put(f"virtual/{step}/stats", stats)
        _, o, f, s = dht_read(st, _t(inp["keys"]))
        out.put(f"virtual/{step}/read", {"out": o, "found": f,
                                         "epoch": s["epoch"]})
        out.slab(f"virtual/{step}/slab", st)


def _read_rows(out: "_Out", prefix: str, res) -> None:
    o, f, s = res
    out.put(prefix, {"out": o, "found": f, "hits": s["hits"],
                     "misses": s["misses"],
                     "fallback_reads": s["fallback_reads"]})


def _virtual_crash(out: "_Out") -> None:
    """The crash sequence on the port's virtual-shard backend (the
    group's batches whole): the slab words after each mutating step."""
    from repro_torch.core import (DHTConfig, crash_shard, dht_create,
                                  dht_write_replicated, recover_shard,
                                  repair_run, ring_create)

    inp = fault_inputs()
    cfg = DHTConfig(n_shards=FAULT_WORLD, n_replicas=2,
                    buckets_per_shard=FAULT_BUCKETS, capacity=FAULT_N)
    st = dht_create(cfg, ring_create(FAULT_WORLD), device="cpu")
    st, _ = dht_write_replicated(st, _t(inp["k1"]), _t(inp["v1"]))
    out.slab("virtual/s_w1", st)
    st = crash_shard(st, FAULT_VICTIM)
    st, _ = dht_write_replicated(st, _t(inp["k2"]), _t(inp["v2"]))
    out.slab("virtual/s_w2", st)
    st = recover_shard(st, FAULT_VICTIM)
    st, _ = repair_run(st, FAULT_VICTIM, batch=FAULT_BATCH)
    out.slab("virtual/s_rep", st)


def group_faults(rank: int, out: _Out) -> None:
    """Crash tolerance on 4 ranks, k=2, capacity > 0: a replicated write,
    the crash of shard FAULT_VICTIM (wiped), a failover read, a write
    during the outage, the recovery, reads across the availability gap,
    the lockstep repair and a second (idle) one; then the L1 crash fence
    on a table with an L1, and the write retry on overflow at k=1 and
    k=2.  Rank 0 also runs the sequence on the virtual backend."""
    import torch

    from repro_torch.core import DHTConfig, L1Config, ring_create
    from repro_torch.core.distributed import ShardedDHT

    world = FAULT_WORLD

    def rows(a):
        return _t(block(a, rank, world))

    def table(k, cap, **kw):
        cfg = DHTConfig(n_shards=world, n_replicas=k,
                        buckets_per_shard=FAULT_BUCKETS, capacity=cap)
        return ShardedDHT.create(cfg, device="cpu", ring=ring_create(world),
                                 **kw)

    inp = fault_inputs()
    k1, v1, k2, v2 = (rows(inp[n]) for n in ("k1", "v1", "k2", "v2"))
    d = table(2, FAULT_CAP)
    out.put("sharded/w1", d.write(k1, v1))
    out.slab("sharded/s_w1", d.state)
    d.crash(FAULT_VICTIM)
    _read_rows(out, "sharded/r_out1", d.read(k1))
    out.put("sharded/w2", d.write(k2, v2))
    out.slab("sharded/s_w2", d.state)
    d.recover(FAULT_VICTIM)
    _read_rows(out, "sharded/r_gap1", d.read(k1))
    _read_rows(out, "sharded/r_gap2", d.read(k2))
    out.put("sharded/rep", d.repair(FAULT_VICTIM, batch=FAULT_BATCH))
    out.slab("sharded/s_rep", d.state)
    _read_rows(out, "sharded/r_fin1", d.read(k1))
    _read_rows(out, "sharded/r_fin2", d.read(k2))
    out.put("sharded/rep2", d.repair(FAULT_VICTIM, batch=FAULT_BATCH))

    keys, vals = (rows(a) for a in kv(FAULT_N, 9))
    d = table(2, FAULT_CAP, l1cfg=L1Config(n_sets=64, n_ways=4))
    d.write(keys, vals)
    for i in range(4):
        if i == 2:
            d.crash(FAULT_VICTIM)
        o, f, s = d.read(keys)
        out.put(f"fence/{i}", {"out": o, "found": f,
                               "l1_hits": s["l1_hits"],
                               "fallback_reads": s["fallback_reads"]})

    keys, vals = (rows(a) for a in kv(FAULT_N, 5))
    for k in (1, 2):
        first = table(k, FAULT_SHARDED_RETRY_CAP).write(keys, vals,
                                                        max_retries=0)
        d = table(k, FAULT_SHARDED_RETRY_CAP)
        ws = d.write(keys, vals)
        out.put(f"retry{k}", {"first_dropped": first["dropped"],
                              "write_retries": ws["write_retries"],
                              "dropped": ws["dropped"], "code": ws["code"],
                              **{lane: ws[lane] for lane in (
                                  "acked", "replica_writes") if lane in ws}})
        out.slab(f"retry{k}/slab", d.state)
        # read back in thin chunks: a pair's bin holds at most its cap
        step = FAULT_SHARDED_RETRY_CAP
        got = [d.read(keys[lo:lo + step])
               for lo in range(0, keys.shape[0], step)]
        out.put(f"retry{k}/out", torch.cat([g[0] for g in got]))
        out.put(f"retry{k}/found", torch.cat([g[1] for g in got]))
    if rank == 0:
        _virtual_crash(out)


GROUPS = {"modes": group_modes, "tier": group_tier,
          "elastic": group_elastic}
# ranks a group runs on (WORLD unless named)
GROUP_WORLD = {"elastic": ELASTIC_WORLD}
# groups run by other test files than tests/test_torch_distributed.py
OTHER_GROUPS = {"faults": group_faults}


def main(argv) -> int:
    name, rank, world, port, out_dir = argv
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)        # ranks share the suite's cores
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    out = _Out()
    try:
        {**GROUPS, **OTHER_GROUPS}[name](rank, out)
    finally:
        dist.destroy_process_group()
    np.savez(f"{out_dir}/{name}_rank{rank}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
