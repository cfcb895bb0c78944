"""The port's host-level async simulator (``repro_torch.core.async_sim``)
against the JAX package's: the numpy murmur hashes against the
reference's and against the port's plain ``hash64``/``checksum`` on seeded
rows, the torn-read workload's stats in all three modes at the reference
test's size, the issue/commit oracle's crash/recover/repair transitions,
and ring placement."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.async_sim as J
from repro.core import DHTConfig as JConfig
from repro_torch.core import DHTConfig
from repro_torch.core import async_sim as T
from repro_torch.kernels import ref as plain


def _rows(seed, n, w):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(n, w), dtype=np.uint64).astype(
        np.uint32)


@pytest.mark.parametrize("kw", [1, 20, 33])
def test_hashes_match_reference_and_plain(kw):
    keys, vals = _rows(kw, 257, kw), _rows(kw + 1, 257, 26)
    hi, lo = T.hash64_np(keys)
    jhi, jlo = J.hash64_np(keys)
    np.testing.assert_array_equal(hi, jhi)
    np.testing.assert_array_equal(lo, jlo)
    both = plain.hash64(torch.from_numpy(keys.view(np.int32))).numpy()
    np.testing.assert_array_equal(hi, both[:, 0].view(np.uint32))
    np.testing.assert_array_equal(lo, both[:, 1].view(np.uint32))
    cs = T.checksum_np(keys, vals)
    np.testing.assert_array_equal(cs, J.checksum_np(keys, vals))
    np.testing.assert_array_equal(cs, plain.checksum(
        torch.from_numpy(keys.view(np.int32)),
        torch.from_numpy(vals.view(np.int32))).numpy().view(np.uint32))


@pytest.mark.parametrize("dist", ["zipf", "uniform"])
@pytest.mark.parametrize("mode", ["lockfree", "fine", "coarse"])
def test_mixed_workload_stats_match_reference(mode, dist):
    """8 ranks x 250 ops, seed 3 (the reference test's size): every
    counter equal; zipf in lock-free mode shows torn reads, uniform and
    the locked modes none."""
    kw = dict(n_shards=4, buckets_per_shard=4096, mode=mode)
    got = T.run_mixed_workload(DHTConfig(**kw), n_ranks=8, ops_per_rank=250,
                               dist=dist, seed=3)
    want = J.run_mixed_workload(JConfig(**kw), n_ranks=8, ops_per_rank=250,
                                dist=dist, seed=3)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.reads > 0 and got.writes > 0
    if mode == "lockfree" and dist == "zipf":
        assert got.mismatches > 0
    if mode != "lockfree":
        assert got.mismatches == 0 and got.lock_round_trips > 0


def test_async_dht_sub_ops_match_reference():
    """Interleaved write halves and reads, driven call for call: the
    tables' words and the stats agree after every step."""
    cfg = dict(n_shards=2, buckets_per_shard=64, mode="lockfree")
    got, want = T.AsyncDHT(DHTConfig(**cfg), seed=1), J.AsyncDHT(
        JConfig(**cfg), seed=1)
    keys, vals = _rows(5, 40, 20), _rows(6, 40, 26)
    rng = np.random.default_rng(7)
    for i in range(40):
        k = keys[rng.integers(0, 10)]
        if rng.random() < 0.5:
            got.write_begin(k, vals[i])
            want.write_begin(k, vals[i])
        else:
            a, b = got.read(k), want.read(k)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        if rng.random() < 0.3:
            got.write_commit()
            want.write_commit()
        for f in ("keys", "vals", "meta", "csum"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)


def test_oracle_replica_transitions_match_reference():
    """The oracle with a placement (each key on 2 of 4 shards): writes,
    reads, a crash, a read that misses the dead owner's copy only where
    no successor holds one, recovery and repair: both oracles agree."""
    keys, vals = _rows(8, 12, 20), _rows(9, 12, 26)

    def placement(k):
        s = int(np.asarray(k, np.uint32)[0]) % 4
        return (s, (s + 1) % 4)

    got = T.IssueCommitOracle(n_shards=4, placement=placement)
    want = J.IssueCommitOracle(n_shards=4, placement=placement)
    for o in (got, want):
        o.commit(o.issue_write(keys[:8], vals[:8]))
    owner = placement(keys[0])[0]
    steps = [("crash", owner), ("read", None), ("write", None),
             ("recover", owner), ("read", None), ("repair", owner),
             ("read", None), ("crash", placement(keys[0])[1]),
             ("read", None)]
    for what, arg in steps:
        if what == "read":
            a = got.commit(got.issue_read(keys))
            b = want.commit(want.issue_read(keys))
            assert a[1] == b[1]
            for x, y in zip(a[0], b[0]):
                assert (x is None) == (y is None)
                if x is not None:
                    np.testing.assert_array_equal(x, y)
        elif what == "write":
            assert got.commit(got.issue_write(keys[8:], vals[8:])) == \
                want.commit(want.issue_write(keys[8:], vals[8:]))
        elif what == "repair":
            assert got.repair(arg, keys) == want.repair(arg, keys) > 0
        else:
            getattr(got, what)(arg)
            getattr(want, what)(arg)
        assert got.holders == want.holders and got.alive == want.alive


def test_async_dht_ring_waits_for_elastic_membership():
    """Ring placement (elastic membership, now ported): every key's
    bucket lies on the shard ``ring_owner_np`` names, the port's ring
    and the reference's place keys alike, and the simulator's bucket is
    the reference simulator's under the same ring."""
    from repro.core.membership import ring_create as j_ring_create
    from repro_torch.core.membership import ring_create, ring_owner_np

    cfg, jcfg = (DHTConfig(n_shards=4, buckets_per_shard=256),
                 JConfig(n_shards=4, buckets_per_shard=256))
    got = T.AsyncDHT(cfg, ring=ring_create(4, n_virtual=16))
    want = J.AsyncDHT(jcfg, ring=j_ring_create(4, n_virtual=16))
    keys = _rows(9, 300, cfg.key_words)
    owner = ring_owner_np(got.ring, T.hash64_np(keys)[0])
    buckets = [got._bucket_of(k) for k in keys]
    assert buckets == [want._bucket_of(k) for k in keys]
    np.testing.assert_array_equal(
        np.array(buckets) // cfg.buckets_per_shard, owner)
    assert len(set(owner.tolist())) == 4
