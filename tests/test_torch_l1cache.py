"""The locality tier on the CPU: the port's L1 cache, ``dht_read_cached``
and ``lookup_cached`` against the JAX package on the same seeded inputs,
word for word.

- ``fold32``/``l1_slots``, the plain ``l1_probe`` against the Pallas kernel
  in interpret mode and its oracle, ``l1_insert`` among duplicates and
  ``l1_flush``;
- the reference's cached-read parity stream in all three modes: the same
  values, found flags, ``l1_hits`` and wire words per read, and the same
  slab and L1 words at the end (carried back with ``convert.l1_to_numpy``);
- the coherence fence: a write after a cached read, an INVALID-flagged
  bucket, the watermark's growth;
- the reference benchmark's stream (``benchmarks/bench_l1_locality.py``,
  quick shape) batch by batch, and ``lookup_cached``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import l1cache as JL
from repro.core.hashing import hash64 as j_hash64
from repro.core.layout import shard_watermark as j_watermark
from repro.kernels.l1_kernel import l1_probe_pallas
from repro.kernels.ref import ref_l1_probe
from repro_torch import core as T
from repro_torch.convert import (
    l1_from_numpy,
    l1_to_numpy,
    state_from_numpy,
    state_to_numpy,
)
from repro_torch.core import l1cache
from repro_torch.core.hashing import hash64
from repro_torch.core.layout import INVALID, OCCUPIED, shard_watermark
from repro_torch.kernels import ops, ref
from repro_torch.obs import metrics

KW, VW = 20, 26
L1_FIELDS = ("keys", "vals", "csum", "gen", "owner", "wmark", "epoch", "live",
             "shard_wmark")


def _t(a):
    """uint32/int32 numpy -> int32 bit-view torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u(t):
    return t.cpu().numpy().view(np.uint32)


def _kv(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2**31, size=(n, KW)).astype(np.uint32),
            rng.integers(0, 2**31, size=(n, VW)).astype(np.uint32))


def _pair(**cfg_kw):
    jcfg = J.DHTConfig(**cfg_kw)
    js = J.dht_create(jcfg)
    ts = state_from_numpy(dataclasses.asdict(jcfg), *(
        np.asarray(getattr(js, k)) for k in ("keys", "vals", "meta", "csum")),
        device="cpu")
    return js, ts


def _l1_pair(n_shards, **l1_kw):
    return (J.l1_create(J.L1Config(**l1_kw), n_shards),
            T.l1_create(T.L1Config(**l1_kw), n_shards, device="cpu"))


def _assert_tables_equal(js, ts):
    for k, v in state_to_numpy(ts).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(js, k)), k)


def _assert_l1_equal(jl, tl):
    tn = l1_to_numpy(tl)
    for k in L1_FIELDS:
        a = np.asarray(getattr(jl, k))
        assert tn[k].dtype == a.dtype and tn[k].shape == a.shape, k
        np.testing.assert_array_equal(tn[k], a, k)


def _cached_both(js, jl, ts, tl, keys):
    """One cached read in each package; the results must be equal."""
    js, jl, jo, jf, jsc = J.dht_read_cached(js, jl, jnp.asarray(keys))
    ts, tl, to, tf, tsc = T.dht_read_cached(ts, tl, _t(keys))
    np.testing.assert_array_equal(_u(to), np.asarray(jo))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    for k in ("hits", "misses", "l1_hits", "mismatches", "dropped",
              "lock_tokens", "wire_words", "bin_counts"):
        np.testing.assert_array_equal(np.asarray(tsc[k]), np.asarray(jsc[k]),
                                      k)
    return js, jl, ts, tl, to, tf, tsc


# ---------------------------------------------------------------------------
# the cache's own functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_sets,n_ways", [(1024, 4), (7, 3), (1, 1)])
def test_fold32_and_slots_match_reference(n_sets, n_ways):
    keys, _ = _kv(500, n_sets + n_ways)
    jh = j_hash64(jnp.asarray(keys))
    th = hash64(_t(keys))
    np.testing.assert_array_equal(_u(l1cache.fold32(*th)),
                                  np.asarray(JL.fold32(*jh)))
    js, jw = JL.l1_slots(J.L1Config(n_sets=n_sets, n_ways=n_ways), *jh)
    ts, tw = l1cache.l1_slots(T.L1Config(n_sets=n_sets, n_ways=n_ways), *th)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert ts.dtype == tw.dtype == torch.int32


def _l1_probe_case(sets, ways, n, seed):
    """Random lines and flags; half the queries are stored lines, half
    foreign keys; query 0's key sits in two ways of its set, the first of
    them incoherent."""
    rng = np.random.default_rng(seed)
    lkeys = rng.integers(0, 2**32, size=(sets, ways, KW), dtype=np.uint64
                         ).astype(np.uint32)
    lvals = rng.integers(0, 2**32, size=(sets, ways, VW), dtype=np.uint64
                         ).astype(np.uint32)
    flags = rng.integers(0, 2, size=(sets, ways)).astype(bool)
    set_idx = rng.integers(0, sets, size=n).astype(np.int32)
    way = rng.integers(0, ways, size=n)
    q = np.array(lkeys[set_idx, way])
    foreign = rng.integers(0, 2, size=n).astype(bool)
    q[foreign] = rng.integers(0, 2**31, size=(int(foreign.sum()), KW))
    if ways > 1:
        s = set_idx[0]
        lkeys[s, 1] = lkeys[s, 0]
        q[0] = lkeys[s, 0]
        flags[s, 0], flags[s, 1] = False, True
    return lkeys, lvals, flags, q, set_idx


@pytest.mark.parametrize("sets,ways,n", [(32, 4, 200), (5, 1, 40),
                                         (16, 8, 300)])
def test_l1_probe_matches_pallas_and_oracle(sets, ways, n):
    lkeys, lvals, flags, q, set_idx = _l1_probe_case(sets, ways, n,
                                                     sets * ways)
    j = [jnp.asarray(a) for a in (lkeys, lvals, flags, q, set_idx)]
    oh, ov = ref_l1_probe(*j)
    kh, kv = l1_probe_pallas(*j, interpret=True)
    for th, tv in (ref.l1_probe(_t(lkeys), _t(lvals), torch.from_numpy(flags),
                                _t(q), torch.from_numpy(set_idx)),
                   ops.l1_probe(_t(lkeys), _t(lvals),
                                torch.from_numpy(flags.astype(np.uint8)),
                                _t(q), torch.from_numpy(set_idx))):
        assert th.dtype == torch.bool and tv.dtype == torch.int32
        np.testing.assert_array_equal(th.numpy(), np.asarray(oh))
        np.testing.assert_array_equal(th.numpy(), np.asarray(kh))
        np.testing.assert_array_equal(_u(tv), np.asarray(ov))
        np.testing.assert_array_equal(_u(tv), np.asarray(kv))
    assert bool(oh.any()) and not bool(oh.all())
    if ways > 1:            # the coherent second copy served query 0
        assert bool(oh[0])
        np.testing.assert_array_equal(_u(tv)[0], lvals[set_idx[0], 1])


def test_l1_insert_matches_reference_and_dedups():
    """A batch with many items on few lines: the highest index wins each
    line, as in the reference; then the flush drops every line."""
    rng = np.random.default_rng(8)
    keys, vals = _kv(64, 9)
    keys[32:] = keys[:32]                      # duplicate keys, new values
    jcfg = J.L1Config(n_sets=8, n_ways=2)
    tcfg = T.L1Config(n_sets=8, n_ways=2)
    jl, tl = _l1_pair(4, n_sets=8, n_ways=2)
    jh = j_hash64(jnp.asarray(keys))
    set_idx, way_idx = JL.l1_slots(jcfg, *jh)
    gen = rng.integers(0, 2**24, size=64).astype(np.uint32)
    owner = rng.integers(0, 4, size=64).astype(np.int32)
    wmark = rng.integers(0, 2**32, size=64, dtype=np.uint64).astype(np.uint32)
    mask = rng.random(64) < 0.8
    set_idx, way_idx = np.array(set_idx), np.array(way_idx)
    jl = JL.l1_insert(jcfg, jl, jnp.asarray(keys), jnp.asarray(vals),
                      jnp.asarray(gen), jnp.asarray(owner), jnp.asarray(wmark),
                      3, set_idx, way_idx, jnp.asarray(mask))
    tl = l1cache.l1_insert(
        tcfg, tl, _t(keys), _t(vals), _t(gen), torch.from_numpy(owner),
        _t(wmark), 3, torch.from_numpy(np.asarray(set_idx)),
        torch.from_numpy(np.asarray(way_idx)), torch.from_numpy(mask))
    _assert_l1_equal(jl, tl)
    # the later duplicate's value is the one served
    last = max(i for i in range(32, 64) if mask[i])
    flags = torch.ones((8, 2), dtype=torch.bool)
    s = torch.from_numpy(set_idx)
    hit, val = l1cache.l1_probe(tcfg, tl, _t(keys[last:last + 1]),
                                s[last:last + 1], flags)
    assert bool(hit[0])
    np.testing.assert_array_equal(_u(val)[0], vals[last])
    before = metrics.counter_value("l1.flushes")
    tl = T.l1_flush(tl)
    assert metrics.counter_value("l1.flushes") == before + 1
    assert not bool(tl.live.any())
    jl = J.l1_flush(jl)
    _assert_l1_equal(jl, tl)


def test_l1_convert_round_trip_and_bytes():
    """A reference cache carried into the port and back unchanged; the
    config's byte count is the reference's."""
    js, ts = _pair(n_shards=8, buckets_per_shard=512)
    jl, _ = _l1_pair(8, n_sets=128, n_ways=4)
    keys, vals = _kv(128, 1)
    js, _ = J.dht_write(js, jnp.asarray(keys), jnp.asarray(vals))
    js, jl, _, _, _ = J.dht_read_cached(js, jl, jnp.asarray(keys))
    arrays = {k: np.asarray(getattr(jl, k)) for k in L1_FIELDS}
    tl = l1_from_numpy(dataclasses.asdict(jl.cfg), **arrays, device="cpu")
    _assert_l1_equal(jl, tl)
    assert tl.cfg.bytes == jl.cfg.bytes
    assert tl.cfg.n_lines == jl.cfg.n_lines


# ---------------------------------------------------------------------------
# the cached read against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", T.MODES)
def test_cached_read_parity_mixed_stream(mode):
    """Interleaved writes and cached reads in both packages: the same
    values, found flags, l1_hits and wire words per read, and the same
    slab and L1 words at the end; and every cached read equals the port's
    own uncached read of a twin table."""
    js, ts = _pair(n_shards=8, buckets_per_shard=512, mode=mode)
    tp = ts.clone()
    jl, tl = _l1_pair(8, n_sets=128, n_ways=4)
    keys, vals = _kv(256, 0)
    rng = np.random.default_rng(3)
    total = 0
    for step in range(4):
        sl = rng.integers(0, 256, size=48)
        wk, wv = keys[sl], vals[sl] + np.uint32(step)
        js, jws = J.dht_write(js, jnp.asarray(wk), jnp.asarray(wv))
        ts, tws = T.dht_write(ts, _t(wk), _t(wv))
        tp, _ = T.dht_write(tp, _t(wk), _t(wv))
        assert int(tws["rounds"]) == int(jws["rounds"])
        assert int(tws["lock_tokens"]) == int(jws["lock_tokens"])
        for _ in range(2):
            qk = keys[rng.integers(0, 256, size=128)]
            js, jl, ts, tl, to, tf, sc = _cached_both(js, jl, ts, tl, qk)
            tp, pv, pf, _ = T.dht_read(tp, _t(qk))
            assert torch.equal(to, pv) and torch.equal(tf, pf)
            total += int(sc["l1_hits"])
    _assert_tables_equal(js, ts)
    _assert_l1_equal(jl, tl)
    assert total > 0, "the stream must exercise the L1 fast path"


@pytest.mark.parametrize("mode", T.MODES)
def test_write_after_cached_read_returns_new_value(mode):
    """A line never outlives a write to its key: the write round never
    touches the cache, the watermark fence retires the line."""
    cfg = T.DHTConfig(n_shards=4, buckets_per_shard=1024, mode=mode)
    st = T.dht_create(cfg, device="cpu")
    l1 = T.l1_create(T.L1Config(n_sets=128, n_ways=4), 4, device="cpu")
    keys, vals = (_t(a) for a in _kv(128, 0))
    st, _ = T.dht_write(st, keys, vals)
    st, l1, _, _, _ = T.dht_read_cached(st, l1, keys)          # fill
    st, l1, _, _, s2 = T.dht_read_cached(st, l1, keys)         # hot
    assert int(s2["l1_hits"]) > 100
    st, _ = T.dht_write(st, keys, vals + 7)
    st, l1, out, found, s3 = T.dht_read_cached(st, l1, keys)
    assert bool(found.all()) and torch.equal(out, vals + 7)
    assert int(s3["l1_hits"]) == 0, "stale lines must not be served"
    st, l1, out, _, s4 = T.dht_read_cached(st, l1, keys)       # re-warmed
    assert int(s4["l1_hits"]) > 100 and torch.equal(out, vals + 7)


def test_invalid_flagged_bucket_not_served():
    """Flagging buckets INVALID changes the shard watermark, so the lines
    they back miss, as the uncached read does."""
    cfg = T.DHTConfig(n_shards=4, buckets_per_shard=1024)
    st = T.dht_create(cfg, device="cpu")
    l1 = T.l1_create(T.L1Config(n_sets=128, n_ways=4), 4, device="cpu")
    keys, vals = (_t(a) for a in _kv(64, 0))
    st, _ = T.dht_write(st, keys, vals)
    st, l1, _, found, _ = T.dht_read_cached(st, l1, keys)
    assert bool(found.all())
    occ = (st.flat_meta & OCCUPIED) != 0
    st.flat_meta[occ] |= INVALID
    _, _, found_p, _ = T.dht_read(st.clone(), keys)
    assert not bool(found_p.any())
    st, l1, out, found, sc = T.dht_read_cached(st, l1, keys)
    assert not bool(found.any()) and int(sc["l1_hits"]) == 0
    assert not bool(out.any())


def test_watermark_grows_under_protocol_transitions():
    """The property the fence rests on, with the reference's words."""
    cfg = T.DHTConfig(n_shards=2, buckets_per_shard=256)
    st = T.dht_create(cfg, device="cpu")
    keys, vals = (_t(a) for a in _kv(64, 0))
    w0 = shard_watermark(st.meta)
    st, _ = T.dht_write(st, keys, vals)
    w1 = shard_watermark(st.meta)
    st, _ = T.dht_write(st, keys, vals + 1)                  # updates
    w2 = shard_watermark(st.meta)
    assert (w1 > w0).all() and (w2 > w1).all()
    first = int(torch.nonzero(st.meta[0] & OCCUPIED)[0, 0])
    st.meta[0, first] |= INVALID
    w3 = shard_watermark(st.meta)
    assert w3[0] > w2[0] and w3[1] == w2[1]
    np.testing.assert_array_equal(
        w3.numpy(), np.asarray(j_watermark(jnp.asarray(_u(st.meta))))
        .astype(np.int64))


@pytest.mark.parametrize("dist", ["zipf", "uniform"])
def test_l1_ref_stream_matches_reference(dist):
    """``benchmarks/bench_l1_locality.py``'s quick stream (S=8, B=2^10,
    2,048 keys, L1 1024 x 4, 4 batches of 2,048, batch 0 warming), drawn
    in the bench's order: per batch the same values, found flags,
    l1_hits and wire words as the JAX package, the final L1 equal, and
    the reference's gates on the Zipf stream."""
    universe, n, s = 2048, 2048, 8
    rng = np.random.default_rng(11)
    ukeys = rng.integers(0, 2**31, size=(universe, KW)).astype(np.uint32)
    uvals = rng.integers(0, 2**31, size=(universe, VW)).astype(np.uint32)

    def ids():
        if draw == "zipf":
            return rng.zipf(1.1, size=n) % universe
        return rng.integers(0, universe, size=n)

    for draw in ("zipf", "uniform"):
        batches = [ukeys[ids()] for _ in range(4)]
        if draw == dist:
            break
    js, ts = _pair(n_shards=s, buckets_per_shard=1 << 10)
    js, _ = J.dht_write(js, jnp.asarray(ukeys), jnp.asarray(uvals))
    ts, ws = T.dht_write(ts, _t(ukeys), _t(uvals))
    assert int(ws["dropped"]) == 0
    jl, tl = _l1_pair(s, n_sets=1024, n_ways=4)
    hits = wire_c = wire_p = 0
    for i, kb in enumerate(batches):
        js, jl, ts, tl, to, tf, sc = _cached_both(js, jl, ts, tl, kb)
        _, pv, pf, sp = T.dht_read(ts.clone(), _t(kb))
        assert torch.equal(to, pv) and torch.equal(tf, pf)
        if i:
            hits += int(sc["l1_hits"])
            wire_c += int(sc["wire_words"])
            wire_p += int(sp["wire_words"])
    _assert_l1_equal(jl, tl)
    hit_frac, wire_ratio = hits / (3 * n), wire_p / wire_c
    if dist == "zipf":
        assert hit_frac >= 0.5 and wire_ratio >= 1.5, (hit_frac, wire_ratio)


def test_lookup_cached_matches_reference():
    """POET-shaped rows (sig 3) drawn from a few distinct states, some
    stored: ``lookup_cached`` gives the reference's outputs and found
    flags, equals ``lookup``, and its second call serves from the L1."""
    rng = np.random.default_rng(6)
    states = (10.0 ** rng.uniform(-3, 2, size=(96, 10))).astype(np.float32)
    rows = states[rng.integers(0, 96, size=128)]
    dcfg = J.DHTConfig(n_shards=8, buckets_per_shard=512)
    jcfg = J.SurrogateConfig(sig_digits=3, dht=dcfg)
    tcfg = T.SurrogateConfig(sig_digits=3, dht=T.DHTConfig(
        n_shards=8, buckets_per_shard=512))
    js, ts = _pair(n_shards=8, buckets_per_shard=512)
    out = states[:64, list(range(10)) + [0, 1, 2]] * 2.0 + 1.0
    js, _ = J.store(jcfg, js, jnp.asarray(states[:64]), jnp.asarray(out))
    ts, _ = T.store(tcfg, ts, torch.from_numpy(states[:64]),
                    torch.from_numpy(out))
    jl, tl = _l1_pair(8, n_sets=128, n_ways=4)
    for call in range(2):
        js, jl, jo, jf, jsc = J.lookup_cached(jcfg, js, jl, jnp.asarray(rows))
        ts, tl, to, tf, tsc = T.lookup_cached(tcfg, ts, tl,
                                              torch.from_numpy(rows))
        np.testing.assert_array_equal(to.numpy().view(np.uint32),
                                      np.asarray(jo).view(np.uint32))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        assert int(tsc["l1_hits"]) == int(jsc["l1_hits"])
        _, po, pf, _ = T.lookup(tcfg, ts.clone(), torch.from_numpy(rows))
        assert torch.equal(to, po) and torch.equal(tf, pf)
    assert bool(tf.any()) and not bool(tf.all())
    assert int(tsc["l1_hits"]) > 0
    _assert_l1_equal(jl, tl)
