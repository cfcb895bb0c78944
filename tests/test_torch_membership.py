"""The port's consistent-hash ring (``repro_torch.core.membership``)
against the JAX package's, on the CPU.

Every ring of a membership sequence (create, grow, leave, join, crash,
recover, shrink) at S in {1, 4, 8} has the reference's vnode positions,
owners, successor table, live count, liveness and epoch, word for word;
the lookups (``ring_owner_of``, ``ring_owner_np``, ``ring_successors``,
``ring_successors_np``) agree with the reference's on 4,096 seeded hashes
plus 0, 0xFFFFFFFF, every vnode position and its neighbours.  The
reference's four ring-property tests (``tests/test_membership.py``) are
mirrored on the port.  Two consumers of ring placement: the host
simulator (``async_sim.AsyncDHT(ring=)``: every counter and meta word of
a torn-read workload equal the reference's), and the smallest migration
(``test_shrink_into_full_table_reports_destination_evictions``: S=4,
B=16, a window of 4, 48 keys shrunk onto one shard, stats and slab words
equal the reference's).  Bit for bit throughout.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in an xdist worker)

import repro.core as JC
from repro.core import async_sim as j_async
from repro.core import membership as J
from repro_torch import core as TC
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import async_sim as t_async
from repro_torch.core import membership as T

SIZES = (1, 4, 8)


def _sequence(mod, s: int):
    """The membership sequence at S = s: (label, ring) pairs."""
    out = [("create", mod.ring_create(s))]
    out.append(("grow", mod.ring_resize(out[-1][1], s + 1)))
    out.append(("leave", mod.ring_leave(out[-1][1], s)))
    out.append(("join", mod.ring_join(out[-1][1], s)))
    out.append(("crash", mod.ring_crash(out[-1][1], 0)))
    out.append(("recover", mod.ring_recover(out[-1][1], 0)))
    out.append(("shrink", mod.ring_resize(out[-1][1], s)))
    return out


@pytest.fixture(scope="module")
def rings():
    return {s: list(zip(_sequence(J, s), _sequence(T, s))) for s in SIZES}


def _hashes(ring_j, n: int = 4096, seed: int = 0) -> np.ndarray:
    """Seeded hashes plus the edges: 0, 0xFFFFFFFF, each vnode position
    and the values either side of it."""
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 2**32, size=n, dtype=np.uint64)
    pos = np.asarray(ring_j.positions).astype(np.uint64)
    edges = np.concatenate([[0, 2**32 - 1], pos, pos + 1, pos - 1])
    return np.concatenate([h, edges % 2**32]).astype(np.uint32)


def _i32(h: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(h.view(np.int32).copy())


@pytest.mark.parametrize("s", SIZES)
def test_ring_arrays_match_reference(rings, s):
    for (label, want), (_, got) in rings[s]:
        np.testing.assert_array_equal(
            got.positions.numpy(),
            np.asarray(want.positions).astype(np.int64), label)
        assert got.positions.dtype == torch.int64
        np.testing.assert_array_equal(got.owners.numpy(),
                                      np.asarray(want.owners), label)
        np.testing.assert_array_equal(got.succ.numpy(),
                                      np.asarray(want.succ), label)
        np.testing.assert_array_equal(got.alive, np.asarray(want.alive))
        assert got.n_live == int(want.n_live), label
        assert got.epoch == int(want.epoch), label
        assert got.n_virtual == want.n_virtual
        assert got.n_shards == want.n_shards
        np.testing.assert_array_equal(T.live_shards(got),
                                      J.live_shards(want))
        # the host arrays the numpy twins read are the same words
        np.testing.assert_array_equal(got.host["positions"],
                                      np.asarray(want.positions))


@pytest.mark.parametrize("s", SIZES)
def test_ring_lookups_match_reference(rings, s):
    for (label, want), (_, got) in rings[s]:
        h = _hashes(want)
        own = J.ring_owner_np(want, h)
        np.testing.assert_array_equal(T.ring_owner_np(got, h), own, label)
        np.testing.assert_array_equal(
            T.ring_owner_of(got, _i32(h)).numpy(), own, label)
        np.testing.assert_array_equal(
            np.asarray(J.ring_owner_of(want, jnp.asarray(h))), own, label)
        for k in range(1, got.succ.shape[1] + 1):
            want_k = np.asarray(J.ring_successors(want, jnp.asarray(h), k))
            np.testing.assert_array_equal(
                T.ring_successors(got, _i32(h), k).numpy(), want_k, label)
            np.testing.assert_array_equal(
                T.ring_successors_np(got, h, k),
                J.ring_successors_np(want, h, k), label)


def test_ring_to_device_and_bad_changes():
    """``to`` keeps one ring per device (itself where it already is);
    membership changes that the reference asserts against raise."""
    ring = T.ring_create(3)
    assert ring.to("cpu") is ring and ring.device.type == "cpu"
    with pytest.raises(ValueError, match="already"):
        T.ring_join(ring, 1)
    with pytest.raises(ValueError, match="last live"):
        T.ring_crash(T.ring_crash(T.ring_create(2), 0), 1)
    with pytest.raises(ValueError, match="out of range"):
        T.ring_successors(ring, torch.zeros(2, dtype=torch.int32), 5)


# ---------------------------------------------------------------------------
# the reference's ring-property tests, on the port
# ---------------------------------------------------------------------------

def _rand(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(n,), dtype=np.uint64).astype(
        np.uint32)


def test_ring_covers_all_live_shards_roughly_evenly():
    ring = T.ring_create(8, n_virtual=64)
    counts = np.bincount(T.ring_owner_np(ring, _rand(20_000)), minlength=8)
    assert (counts > 0).all(), "every live shard must own keys"
    assert counts.max() < 3 * counts.mean()


def test_ring_lookup_torch_matches_np():
    ring = T.ring_create(5, n_virtual=32)
    h = _rand(1000)
    np.testing.assert_array_equal(T.ring_owner_of(ring, _i32(h)).numpy(),
                                  T.ring_owner_np(ring, h))


def test_ring_minimal_disruption_on_leave_and_join():
    ring = T.ring_create(8, n_virtual=64)
    h = _rand(20_000)
    before = T.ring_owner_np(ring, h)
    left = T.ring_leave(ring, 3)
    after = T.ring_owner_np(left, h)
    moved = before != after
    assert (before[moved] == 3).all() and not (after == 3).any()
    assert left.epoch == 1
    back = T.ring_join(left, 3)
    np.testing.assert_array_equal(T.ring_owner_np(back, h), before)
    assert back.epoch == 2


def test_ring_resize_moves_only_captured_keys():
    ring = T.ring_create(4, n_virtual=64)
    h = _rand(20_000)
    before = T.ring_owner_np(ring, h)
    after = T.ring_owner_np(T.ring_resize(ring, 8), h)
    moved = before != after
    assert (after[moved] >= 4).all()
    assert 0.2 < moved.mean() < 0.8


# ---------------------------------------------------------------------------
# consumers of ring placement
# ---------------------------------------------------------------------------

def test_shrink_into_full_table_reports_destination_evictions():
    """Shrinking below capacity cannot be lossless: the loss is reported
    (``evicted_at_dest``), never silent.  48 entries in 4 x 16 buckets
    shrink onto 16, in steps of 16 rows; stats and slab words are the
    reference's (its table filled through ``jax.jit``: nothing drops, so
    the words of an eager fill)."""
    cfg = JC.DHTConfig(n_shards=4, buckets_per_shard=16, n_probe=4)
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**31, size=(48, 20)).astype(np.uint32)
    vals = rng.integers(0, 2**31, size=(48, 26)).astype(np.uint32)
    st = jax.jit(lambda s, k, v: JC.dht_write(s, k, v)[0])(
        JC.dht_create(cfg, JC.ring_create(4)), jnp.asarray(keys),
        jnp.asarray(vals))
    init = {k: np.array(getattr(st, k)) for k in ("keys", "vals", "meta",
                                                   "csum")}
    st, want = JC.dht_resize(st, 1, batch=16)

    ts = state_from_numpy(dataclasses.asdict(cfg), *init.values(),
                          ring=T.ring_create(4), device="cpu")
    n_live = int(TC.dht_occupancy(ts)["live_per_shard"].sum())
    assert n_live > 16, "more live entries than the shrunk table holds"
    ts, got = TC.dht_resize(ts, 1, batch=16)
    assert got == {k: int(v) for k, v in want.items()}
    assert got["evicted_at_dest"] > 0, "the lossy move reports its loss"
    for k, v in state_to_numpy(ts).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(st, k)), k)
    assert int(TC.dht_occupancy(ts)["live_per_shard"].sum()) <= 16


def _ring_workload(mod, cfg, ring, n_ops=1500, seed=3):
    """tests/test_async_sim.py's Zipf read/write mix on ``ring``
    placement: the same calls on either package's AsyncDHT."""
    rng = np.random.default_rng(seed)
    table = mod.AsyncDHT(cfg, seed, ring=ring)
    ids = rng.zipf(1.99, size=n_ops) % 712_500
    is_read = rng.random(n_ops) < 0.95
    for i in range(n_ops):
        key = np.zeros((cfg.key_words,), np.uint32)
        key[0] = np.uint32(int(ids[i]))
        if is_read[i]:
            table.read(key)
        else:
            table.write_begin(key, rng.integers(
                0, 2**31, size=cfg.val_words).astype(np.uint32))
            if rng.random() < 0.7:
                table.write_commit()
        if rng.random() < 0.3:
            table.write_commit()
    while table.pending:
        table.write_commit()
    return dataclasses.asdict(table.stats), table.meta.copy()


def test_async_dht_ring_stats_match_reference():
    """The torn-read workload on ring placement: every counter and every
    meta word of the two simulators equal, torn reads included."""
    kw = dict(n_shards=4, buckets_per_shard=2048)
    got = _ring_workload(t_async, TC.DHTConfig(**kw), T.ring_create(4))
    want = _ring_workload(j_async, JC.DHTConfig(**kw), J.ring_create(4))
    assert got[0] == want[0] and got[0]["mismatches"] > 0
    np.testing.assert_array_equal(got[1], want[1])
