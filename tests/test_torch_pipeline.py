"""The issue/commit pipeline of the port against the JAX package, on the
CPU at S=4, B=512 (KW 20, VW 26), inputs from numpy seeds:

- ``PendingWrites``/``RoundQueue`` against the reference classes, call
  for call;
- ``dht_commit(dht_issue(...))`` against the port's ``dht_execute`` and
  the reference's split, for every op mix in all three modes: values,
  found flags, codes, dropped, rounds, lock tokens and slab words, bit
  for bit;
- the reference's write-at-issue, read-snapshot and promised-write
  forwarding cases;
- random issue/commit interleavings against the port's
  ``IssueCommitOracle`` and the reference's;
- ``lookup_or_compute_pipelined`` at depth 2 against the port's
  sequential loop and the reference's pipelined driver in all three
  modes, with a ``compute_fn`` that both frameworks evaluate exactly (a
  slice times two), so output words compare bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core.async_sim import IssueCommitOracle as JOracle
from repro.core.pipeline import PendingWrites as JPending
from repro.core.pipeline import RoundQueue as JQueue
from repro_torch import core as T
from repro_torch.convert import cfg_from_dict, state_from_numpy, state_to_numpy
from repro_torch.core.async_sim import IssueCommitOracle
from repro_torch.obs import counting

KW, VW = 20, 26
N = 48          # rows per round: one shape, so the reference's eager ops
                # compile once
MODES = ("lockfree", "fine", "coarse")
IDX = list(range(10)) + [0, 1, 2]          # 10 inputs -> 13 outputs


def _words(rng, n, w):
    return rng.integers(0, 2**32, size=(n, w), dtype=np.uint64).astype(
        np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u(x):
    return x.numpy().view(np.uint32) if x.dtype == torch.int32 else x.numpy()


def _pair(**cfg_kw):
    jcfg = J.DHTConfig(n_shards=4, buckets_per_shard=512, **cfg_kw)
    js = J.dht_create(jcfg)
    ts = state_from_numpy(dataclasses.asdict(jcfg), *(
        np.asarray(getattr(js, k)) for k in ("keys", "vals", "meta", "csum")),
        device="cpu")
    return js, ts


def _tables_equal(js, ts):
    for k, v in state_to_numpy(ts).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(js, k)), k)


# ---------------------------------------------------------------------------
# PendingWrites and RoundQueue
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pending_writes_match_reference(seed):
    """Random promise/publish/retire sequences over a small key universe
    (duplicate rows within a call included): after every call both
    tables conflict on the same rows and forward the same words, and
    both raise on the same unpublished resolves."""
    rng = np.random.default_rng(seed)
    universe = _words(rng, 24, KW)
    ref, port = JPending(VW), T.PendingWrites(VW)
    for _ in range(30):
        ids = rng.integers(0, len(universe), size=16)
        keys = universe[ids]
        mask = rng.random(16) < 0.6
        what = rng.integers(0, 3)
        if what == 0:
            ref.promise(keys, mask)
            port.promise(keys, mask)
        elif what == 1:
            vals = _words(rng, 16, VW)
            ref.publish(keys, vals, mask)
            port.publish(_t(keys), _t(vals), torch.from_numpy(mask))
        else:
            ref.retire(keys, mask)
            port.retire(keys, mask)
        assert len(port) == len(ref)
        q = universe[rng.integers(0, len(universe), size=20)]
        valid = rng.random(20) < 0.8
        conf = ref.conflicts(q, valid)
        np.testing.assert_array_equal(port.conflicts(_t(q), valid).numpy(),
                                      conf)
        try:
            want = ref.resolve(q, conf)
        except RuntimeError:
            with pytest.raises(RuntimeError, match="published"):
                port.resolve(q, conf)
        else:
            np.testing.assert_array_equal(_u(port.resolve(q, conf)), want)


def test_pending_writes_edges_match_reference():
    """1-D keys, no mask, an empty table and a value wider than the
    table: the same answers as the reference."""
    ref, port = JPending(3), T.PendingWrites(3)
    keys = np.arange(5, dtype=np.uint32)
    assert not port.conflicts(keys).any() and len(port) == 0
    np.testing.assert_array_equal(_u(port.resolve(keys, np.zeros(5, bool))),
                                  ref.resolve(keys, np.zeros(5, bool)))
    with pytest.raises(RuntimeError):
        port.resolve(keys, np.ones(5, bool))
    vals = np.arange(20, dtype=np.uint32).reshape(5, 4)
    for t in (ref, port):
        t.promise(keys)
        t.publish(keys[:3], vals[:3])
    assert len(port) == len(ref) == 5
    np.testing.assert_array_equal(port.conflicts(keys).numpy(),
                                  ref.conflicts(keys))
    m = np.array([True, True, True, False, False])
    np.testing.assert_array_equal(_u(port.resolve(keys, m)),
                                  ref.resolve(keys, m))
    with pytest.raises(RuntimeError, match="published"):
        port.resolve(keys, ~m)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_round_queue_matches_reference(depth):
    logs = {"ref": [], "port": []}
    qs = {"ref": JQueue(depth, commit=lambda r: (logs["ref"].append(r), r)[1]),
          "port": T.RoundQueue(depth, commit=lambda r: (
              logs["port"].append(r), r)[1])}
    for name in "abcde":
        assert qs["port"].push(name) == qs["ref"].push(name)
        assert len(qs["port"]) == len(qs["ref"])
    assert qs["port"].drain() == qs["ref"].drain()
    assert logs["port"] == logs["ref"] == list("abcde")
    with pytest.raises(ValueError):
        T.RoundQueue(0)
    assert T.RoundQueue(depth).commit is T.dht_commit


# ---------------------------------------------------------------------------
# the split halves
# ---------------------------------------------------------------------------

def _mix_stream(seed=3, n=N):
    rng = np.random.default_rng(seed)
    keys, vals = _words(rng, n, KW), _words(rng, n, VW)
    op = np.where(rng.random(n) < 0.5, J.OP_READ, J.OP_WRITE).astype(np.int32)
    mk = np.concatenate([keys[: n // 2], _words(rng, n // 2, KW)])
    return [
        ("write", keys, vals, None),
        ("read", keys, None, None),
        ("mixed", keys, vals + np.uint32(7), op),
        ("migrate", mk, _words(rng, n, VW), None),
    ]


def _ops(mod, kind, keys, vals, op, conv):
    if kind == "write":
        return mod.write_ops(conv(keys), conv(vals)), ("write",)
    if kind == "read":
        return mod.read_ops(conv(keys)), ("read",)
    if kind == "migrate":
        return mod.migrate_ops(conv(keys), conv(vals)), ("migrate",)
    opt = jnp.asarray(op) if mod is J else torch.from_numpy(op)
    return mod.mixed_ops(opt, conv(keys), conv(vals)), ("read", "write")


@pytest.mark.parametrize("mode", MODES)
def test_issue_commit_matches_execute_and_reference(mode):
    """dht_commit(dht_issue(...)) equals the port's dht_execute and the
    reference's split for a write, read, 50/50 mixed and migrate round:
    values, found, codes, dropped, rounds, lock tokens and the slab words
    after every round, bit for bit."""
    js, ts_split = _pair(mode=mode)
    _, ts_exec = _pair(mode=mode)
    for kind, keys, vals, op in _mix_stream():
        jops, kinds = _ops(J, kind, keys, vals, op, jnp.asarray)
        tops, _ = _ops(T, kind, keys, vals, op, _t)
        js, _, jv, jf, jc, je = J.dht_commit(J.dht_issue(js, jops,
                                                         kinds=kinds))
        rnd = T.dht_issue(ts_split, tops, kinds=kinds)
        assert not rnd.committed and rnd.event is None
        ts_split, prev, tv, tf, tc, te = T.dht_commit(rnd)
        assert prev is None and rnd.committed
        _, _, xv, xf, xc, xe = T.dht_execute(ts_exec, tops, kinds=kinds)
        for got, ex, want in ((tv, xv, jv), (tf, xf, jf), (tc, xc, jc)):
            assert torch.equal(got, ex), kind
            np.testing.assert_array_equal(_u(got), np.asarray(want), kind)
        for lane in ("dropped", "rounds", "lock_tokens", "mismatches",
                     "capacity", "wire_words"):
            assert int(te[lane]) == int(xe[lane]) == int(je[lane]), (
                kind, lane)
        _tables_equal(js, ts_split)
        _tables_equal(js, ts_exec)
    with pytest.raises(RuntimeError, match="twice"):
        T.dht_commit(rnd)


def test_commit_telemetry_and_round_count():
    """Commit fills the four telemetry values and counts one engine
    round; the issue half counts none.  The round's mix counts every
    valid request, forwarded rows included."""
    _, ts = _pair()
    keys = _words(np.random.default_rng(8), N, KW)
    pend = T.PendingWrites(VW)
    pend.promise(keys[:10])
    with counting("engine.rounds") as c:
        rnd = T.dht_read_async(ts, _t(keys), pending=pend)
    assert c.delta == 0 and rnd.telemetry == {}
    assert int(rnd.mix["read"]) == N
    assert int(rnd.conflict.sum()) == 10
    pend.publish(keys[:10], _words(np.random.default_rng(9), 10, VW))
    with counting("engine.rounds") as c:
        T.dht_read_commit(rnd)
    assert c.delta == 1
    tel = rnd.telemetry
    assert set(tel) == {"issue_us", "hidden_us", "commit_wait_us",
                        "overlap_frac"}
    assert tel["issue_us"] > 0 and 0.0 <= tel["overlap_frac"] <= 1.0


def test_pending_filter_is_for_uniform_reads_only():
    _, ts = _pair()
    keys = _words(np.random.default_rng(1), 8, KW)
    pend = T.PendingWrites(VW)
    with pytest.raises(ValueError, match="uniform read"):
        T.dht_issue(ts, T.write_ops(_t(keys), _t(keys)), kinds=("write",),
                    pending=pend)
    # a mesh axis name is no process group of the multi-rank backend
    with pytest.raises(TypeError, match="ProcessGroup"):
        T.dht_read_async(ts, _t(keys), axis_name="d")
    # an empty table attaches no filter
    assert T.dht_read_async(ts, _t(keys), pending=pend).conflict is None


def test_write_effects_land_at_issue_time():
    """A read issued after an uncommitted write sees it, whatever the
    commit order (the reference's case, on the port and the reference)."""
    keys, vals = (_words(np.random.default_rng(5), N, w) for w in (KW, VW))
    js, ts = _pair()
    jw = J.dht_write_async(js, jnp.asarray(keys), jnp.asarray(vals))
    jr = J.dht_read_async(jw.state, jnp.asarray(keys))
    w = T.dht_write_async(ts, _t(keys), _t(vals))
    r = T.dht_read_async(w.state, _t(keys))
    _, out, found, stats = T.dht_read_commit(r)       # the read first
    _, jout, jfound, jstats = J.dht_read_commit(jr)
    assert bool(found.all()) and torch.equal(out, _t(vals))
    np.testing.assert_array_equal(_u(out), np.asarray(jout))
    assert int(stats["hits"]) == int(jstats["hits"]) == N
    _, wst = T.dht_write_commit(w)
    _, jwst = J.dht_write_commit(jw)
    assert int(wst["inserted"]) == int(jwst["inserted"]) == N
    _tables_equal(jw.state, ts)


def test_read_snapshot_semantics():
    """A read issued BEFORE a write snapshots the table without it, no
    matter how late it commits.  The port's state is one buffer, so the
    write is issued against the state the read was issued on, as in the
    reference's case."""
    keys, vals = (_words(np.random.default_rng(6), N, w) for w in (KW, VW))
    _, ts = _pair()
    r = T.dht_read_async(ts, _t(keys))
    w = T.dht_write_async(ts, _t(keys), _t(vals))
    T.dht_write_commit(w)
    _, out, found, stats = T.dht_read_commit(r)
    assert not bool(found.any()) and not bool(out.any())
    assert int(stats["misses"]) == N
    _, out2, found2, _ = T.dht_read(ts, _t(keys))
    assert bool(found2.all()) and torch.equal(out2, _t(vals))


def test_read_after_promised_write_forwards():
    """The promised-write hazard on the port and the reference: the
    conflicted rows are masked out at issue, a commit before the value
    is published raises, and after publishing they come back found with
    the published words, counted as hits."""
    rng = np.random.default_rng(7)
    keys, vals = _words(rng, 48, KW), _words(rng, 48, VW)
    promised = np.zeros(48, bool)
    promised[::3] = True
    js, ts = _pair()
    jp, tp = JPending(VW), T.PendingWrites(VW)
    jp.promise(keys, promised)
    tp.promise(_t(keys), torch.from_numpy(promised))

    early = T.dht_read_async(ts, _t(keys), pending=tp)
    np.testing.assert_array_equal(early.conflict.numpy(), promised)
    with pytest.raises(RuntimeError, match="published"):
        T.dht_read_commit(early)

    rnd = T.dht_read_async(ts, _t(keys), pending=tp)
    jrnd = J.dht_read_async(js, jnp.asarray(keys), pending=jp)
    tp.publish(_t(keys), _t(vals), torch.from_numpy(promised))
    jp.publish(keys, vals, promised)
    _, out, found, stats = T.dht_read_commit(rnd)
    _, jout, jfound, jstats = J.dht_read_commit(jrnd)
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    np.testing.assert_array_equal(_u(out), np.asarray(jout))
    assert (_u(out)[promised] == vals[promised]).all()
    assert not found.numpy()[~promised].any()
    assert int(stats["hits"]) == int(jstats["hits"]) == int(promised.sum())
    assert int(stats["wire_words"]) == int(jstats["wire_words"])


def test_read_many_async_matches_read_many():
    rng = np.random.default_rng(4)
    keys = _words(rng, 60, KW)
    vals = _words(rng, 60, VW)
    _, ts = _pair()
    T.dht_write(ts, _t(keys), _t(vals))
    many = _t(np.concatenate([keys[:40], _words(rng, 20, KW)]).reshape(
        20, 3, KW))
    valid = torch.from_numpy(rng.random((20, 3)) < 0.8)
    _, v1, f1, s1 = T.dht.dht_read_many(ts, many, valid)
    _, v2, f2, s2 = T.dht_read_many_commit(T.dht_read_many_async(ts, many,
                                                                 valid))
    assert torch.equal(v1, v2) and torch.equal(f1, f2)
    assert v2.shape == (20, 3, VW) and f2.shape == (20, 3)
    assert int(s1["hits"]) == int(s2["hits"]) > 0


# ---------------------------------------------------------------------------
# random interleavings against the oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 17, 404, 9000])
def test_interleavings_match_oracles(seed):
    """Reads and writes over a 12-key universe, issued in random order
    against the running state, committed late and out of order: every
    read materializes what the port's IssueCommitOracle and the
    reference's say (issue-time effects and snapshots)."""
    rng = np.random.default_rng(seed)
    _, state = _pair()
    oracles = (IssueCommitOracle(), JOracle())
    universe = _words(np.random.default_rng(0), 12, KW)
    in_flight = []

    def commit_one(idx):
        rnd, handles, kind = in_flight.pop(idx)
        answers = [o.commit(h) for o, h in zip(oracles, handles)]
        if kind == "read":
            _, out, found, _ = T.dht_read_commit(rnd)
            out = _u(out)
            for ovals, ofound in answers:
                assert found.numpy().tolist() == ofound
                for i, v in enumerate(ovals):
                    if v is not None:
                        assert (out[i] == v).all()
        else:
            _, stats = T.dht_write_commit(rnd)
            assert answers[0] == answers[1] == 8
            assert int(stats["dropped"]) == 0

    for _ in range(24):
        keys = universe[rng.integers(0, len(universe), size=8)]
        if rng.random() < 0.45:
            vals = _words(rng, 8, VW)
            rnd = T.dht_write_async(state, _t(keys), _t(vals))
            handles = [o.issue_write(keys, vals) for o in oracles]
            in_flight.append((rnd, handles, "write"))
        else:
            rnd = T.dht_read_async(state, _t(keys))
            handles = [o.issue_read(keys) for o in oracles]
            in_flight.append((rnd, handles, "read"))
        state = rnd.state
        while in_flight and rng.random() < 0.5:
            commit_one(int(rng.integers(0, len(in_flight))))
    while in_flight:
        commit_one(int(rng.integers(0, len(in_flight))))


# ---------------------------------------------------------------------------
# the pipelined surrogate driver
# ---------------------------------------------------------------------------

def compute_fn(x):
    """Exact in f32 in both frameworks: a slice times two."""
    return x[:, IDX] * 2.0


def _batches(n_batches=3, n=N, seed=11):
    """Consecutive batches share rows, so batch N+1 re-reads keys batch N
    is still computing: forwarding must fire."""
    rng = np.random.default_rng(seed)
    out, prev = [], None
    for _ in range(n_batches):
        x = np.round(rng.uniform(0.1, 10.0, size=(n, 10)), 2).astype(
            np.float32)
        if prev is not None:
            x[: n // 3] = prev[rng.integers(0, n, size=n // 3)]
        prev = x
        out.append(x)
    return out


def _cfgs(mode="lockfree", **dht_kw):
    """The surrogate's config in both packages."""
    dcfg = J.DHTConfig(n_shards=4, buckets_per_shard=512, mode=mode,
                       **dht_kw)
    jcfg = J.SurrogateConfig(sig_digits=4, dht=dcfg)
    tcfg = T.SurrogateConfig(sig_digits=4, dht=cfg_from_dict(
        dataclasses.asdict(dcfg)))
    return jcfg, tcfg


@pytest.mark.parametrize("mode", MODES)
def test_surrogate_pipelined_matches_sequential_and_reference(mode):
    jcfg, tcfg = _cfgs(mode)
    batches = _batches(n_batches=2)
    tb = [torch.from_numpy(x) for x in batches]
    st_seq = T.surrogate_create(tcfg, device="cpu")
    seq_outs, seq_found, tot = [], [], {"hits": 0, "misses": 0, "stored": 0}
    for x in tb:
        st_seq, out, found, s = T.lookup_or_compute(tcfg, st_seq, x,
                                                    compute_fn)
        seq_outs.append(out)
        seq_found.append(found)
        for k in tot:
            tot[k] += int(s[k])

    st_p, outs, founds, sp = T.lookup_or_compute_pipelined(
        tcfg, T.surrogate_create(tcfg, device="cpu"), tb, compute_fn,
        depth=2)
    js, jouts, jfounds, jsp = J.lookup_or_compute_pipelined(
        jcfg, J.surrogate_create(jcfg), [jnp.asarray(x) for x in batches],
        compute_fn, depth=2)
    assert sp["forwarded"] > 0, "the crafted overlap must forward"
    assert sp["requeued"] == 0
    for k in tot:
        assert sp[k] == tot[k] == int(jsp[k]), k
    assert sp["forwarded"] == int(jsp["forwarded"])
    for a, b, c in zip(seq_outs, outs, jouts):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(b.numpy().view(np.uint32),
                                      np.asarray(c).view(np.uint32))
    for a, b, c in zip(seq_found, founds, jfounds):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(b.numpy(), np.asarray(c))
    for k, v in state_to_numpy(st_p).items():
        np.testing.assert_array_equal(v, state_to_numpy(st_seq)[k], k)
    _tables_equal(js, st_p)


def test_surrogate_pipelined_depth1_is_sequential():
    _, tcfg = _cfgs()
    tb = [torch.from_numpy(x) for x in _batches()]
    _, outs1, f1, s1 = T.lookup_or_compute_pipelined(
        tcfg, T.surrogate_create(tcfg, device="cpu"), tb, compute_fn,
        depth=1)
    st = T.surrogate_create(tcfg, device="cpu")
    hits = 0
    for x, o, f in zip(tb, outs1, f1):
        st, out, found, s = T.lookup_or_compute(tcfg, st, x, compute_fn)
        assert torch.equal(o, out) and torch.equal(f, found)
        hits += int(s["hits"])
    assert s1["forwarded"] == 0 and s1["hits"] == hits
    _, outs2, _, s2 = T.lookup_or_compute_pipelined(
        tcfg, T.surrogate_create(tcfg, device="cpu"), tb, compute_fn,
        depth=2)
    assert s2["hits"] == s1["hits"]
    for a, b in zip(outs1, outs2):
        assert torch.equal(a, b)
    empty = T.lookup_or_compute_pipelined(
        tcfg, T.surrogate_create(tcfg, device="cpu"), [], compute_fn)
    assert empty[1] == [] and empty[3]["hits"] == 0


def test_surrogate_pipelined_requeues_dropped_rows():
    """A fixed routing capacity below the batch's largest bin makes the
    write-back rounds drop rows; the driver re-issues them, and counts
    them, exactly as the reference's driver does."""
    jcfg, tcfg = _cfgs(capacity=8)
    batches = _batches(n_batches=1)
    _, outs, _, sp = T.lookup_or_compute_pipelined(
        tcfg, T.surrogate_create(tcfg, device="cpu"),
        [torch.from_numpy(x) for x in batches], compute_fn, depth=2)
    js, jouts, _, jsp = J.lookup_or_compute_pipelined(
        jcfg, J.surrogate_create(jcfg), [jnp.asarray(x) for x in batches],
        compute_fn, depth=2)
    assert sp["requeued"] > 0
    for k in ("hits", "misses", "stored", "forwarded", "requeued"):
        assert sp[k] == int(jsp[k]), k
    for b, c in zip(outs, jouts):
        np.testing.assert_array_equal(b.numpy().view(np.uint32),
                                      np.asarray(c).view(np.uint32))
