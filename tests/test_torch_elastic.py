"""What elastic membership changes for the port's consumers of the
table, on the CPU: the surrogate's dual-epoch neighbourhood query
against the JAX package, bit for bit, and the L1 tier's epoch flush.

The reference runs once, in the module fixture ``ref``: an elastic
surrogate cache (S=4, B=1024, sig 3) holding the +-1-step lattice
neighbours of 24 centres and 12 exact rows (filled through ``jax.jit``:
with nothing dropped, the words of an eager fill) grows to 8 shards in
steps of 16 rows, with ``lookup_or_interpolate(prev=)`` on the centres,
the exact rows and far misses after the first step.  The port starts
from the reference's words and makes the same calls.  The L1 flush
(tests/test_l1cache.py:146) is held against the port's own uncached
reads: the reference's eager cached reads would double this file's
time, and the L1 itself is held against the reference in
tests/test_torch_l1cache.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import neighbors as jn
from repro_torch import core as T
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import surrogate as t_surrogate

SIG = 3
BATCH = 16
SLAB = ("keys", "vals", "meta", "csum")
LANES = ("exact", "interpolated", "misses", "probe_hits", "mismatches",
         "dropped", "epoch", "wire_words")


def _scfg(mod):
    dcfg = mod.DHTConfig(n_shards=4, buckets_per_shard=1024)
    return mod.SurrogateConfig(n_inputs=10, n_outputs=13, sig_digits=SIG,
                               dht=dcfg)


def _jcompute(v):
    return jnp.concatenate([v * 2.0, v[:, :3]], axis=-1)


def _jslab(st) -> dict:
    return {k: np.array(getattr(st, k)) for k in SLAB}


def _snapshot(ts) -> dict:
    return {k: v.copy() for k, v in state_to_numpy(ts).items()}


def _u(x: torch.Tensor) -> np.ndarray:
    a = x.numpy()
    return a.view(np.uint32) if a.dtype in (np.int32, np.float32) else a


def _rows(seed=0):
    """(stored rows, queries): the +-1-step neighbours along dim 0 of 24
    lattice centres and 12 exact rows are stored; the centres (bracketed
    near misses), the exact rows and 8 far misses are queried."""
    rng = np.random.default_rng(seed)
    base = jnp.asarray(rng.uniform(1.5, 9.5, size=(24, 10)), jnp.float32)
    center = np.asarray(J.round_significant(base, SIG))
    step = np.asarray(jn.lattice_step(jnp.asarray(center), SIG))
    lo, hi = center.copy(), center.copy()
    lo[:, 0] -= step[:, 0]
    hi[:, 0] += step[:, 0]
    exact = rng.uniform(0.5, 9.5, size=(12, 10)).astype(np.float32)
    far = rng.uniform(20.0, 90.0, size=(8, 10)).astype(np.float32)
    return (np.concatenate([lo, hi, exact]).astype(np.float32),
            np.concatenate([center, exact, far]).astype(np.float32))


@pytest.fixture(scope="module")
def ref():
    cfg = _scfg(J)
    rows, queries = _rows()
    st = jax.jit(lambda s, x: J.store(cfg, s, x, _jcompute(x))[0])(
        J.surrogate_create(cfg, elastic=True), jnp.asarray(rows))
    r = {"init": _jslab(st), "rows": rows, "queries": queries}
    mig = J.migration_begin(st, J.ring_resize(st.ring, 8), batch=BATCH)
    mig, _ = J.migration_step(mig)
    mig.new, mig.old, out, prov, stats = J.lookup_or_interpolate(
        cfg, mig.new, jnp.asarray(queries), J.InterpConfig(), prev=mig.old)
    r["interp"] = (np.array(out), np.array(prov),
                   {k: int(stats[k]) for k in LANES})
    r["mid_new"], r["mid_old"] = _jslab(mig.new), _jslab(mig.old)
    while not mig.done:
        mig, _ = J.migration_step(mig)
    st, r["stats"] = J.migration_finish(mig)
    r["grown"] = _jslab(st)
    return r


def _port(r):
    cfg = _scfg(T)
    return cfg, state_from_numpy(dataclasses.asdict(cfg.dht),
                                 *(r["init"][k] for k in SLAB),
                                 ring=T.ring_create(4), device="cpu")


def test_epoch_change_flushes_l1(ref):
    """A ring migration bumps the epoch: after it no line of the old
    epoch serves (the implicit whole-cache flush), the reads stay right,
    and the cache re-warms in the new epoch.  Every cached read equals
    the uncached read of the same table, bit for bit."""
    cfg, st = _port(ref)
    keys = T.make_keys(cfg, torch.from_numpy(ref["rows"]))
    l1 = T.l1_create(T.L1Config(n_sets=128, n_ways=4), 8, device="cpu")
    got = []

    def cached():
        nonlocal st, l1
        st, l1, out, found, s = T.dht_read_cached(st, l1, keys)
        _, plain, pfound, _ = T.dht_read(st, keys)
        assert torch.equal(out, plain) and torch.equal(found, pfound)
        got.append((found.all().item(), int(s["l1_hits"]), int(s["epoch"])))
    cached()
    cached()
    st, _ = T.dht_resize(st, 8, batch=BATCH)
    cached()
    cached()
    assert all(g[0] for g in got), "every stored row is found"
    assert got[1][1] > 50 and got[1][2] == 0, "the L1 serves the hot rows"
    assert got[2][1:] == (0, 1), "the old epoch's lines are flushed"
    assert got[3][1] > 50 and got[3][2] == 1, "the cache re-warms"


def test_lookup_or_interpolate_mid_migration(ref):
    """``lookup_or_interpolate(prev=)`` after the first step: exact rows,
    interpolated centres and misses as in the reference, outputs bit for
    bit, both epochs' slabs equal; the migration then finishes as the
    reference's did."""
    cfg, st = _port(ref)
    q = torch.from_numpy(ref["queries"])
    mig = T.migration_begin(st, T.ring_resize(st.ring, 8), batch=BATCH)
    mig, _ = T.migration_step(mig)
    new, prev, out, prov, stats = T.lookup_or_interpolate(
        cfg, mig.new, q, T.InterpConfig(), prev=mig.old)
    assert new is mig.new and prev is mig.old
    want_out, want_prov, want_stats = ref["interp"]
    np.testing.assert_array_equal(_u(out), want_out.view(np.uint32))
    np.testing.assert_array_equal(prov.numpy(), want_prov)
    assert {k: int(stats[k]) for k in LANES} == want_stats
    assert want_stats["interpolated"] == 24 and want_stats["exact"] == 12
    for k, v in _snapshot(mig.new).items():
        np.testing.assert_array_equal(v, ref["mid_new"][k], k)
    for k, v in _snapshot(mig.old).items():
        np.testing.assert_array_equal(v, ref["mid_old"][k], k)
    while not mig.done:
        mig, _ = T.migration_step(mig)
    st, stats = T.migration_finish(mig)
    assert stats == {k: int(v) for k, v in ref["stats"].items()}
    for k, v in _snapshot(st).items():
        np.testing.assert_array_equal(v, ref["grown"][k], k)


def test_lookup_prev_reads_both_epochs(ref):
    """``lookup(prev=)`` is the dual read of the rounded keys: every
    stored row is found mid-migration, part of them in the old epoch,
    with the values ``lookup`` gives after the migration."""
    cfg, st = _port(ref)
    x = torch.from_numpy(ref["rows"])
    mig = T.migration_begin(st, T.ring_resize(st.ring, 8), batch=BATCH)
    mig, _ = T.migration_step(mig)
    _, out, found, stats = T.lookup(cfg, mig.new, x, prev=mig.old)
    _, _, vals, found2, _ = T.dht_read_dual(mig.new, mig.old,
                                            T.make_keys(cfg, x))
    assert found.all() and torch.equal(found, found2)
    assert torch.equal(out, T.unpack_floats(vals, cfg.n_outputs))
    assert int(stats["hits_old_epoch"]) > 0
    while not mig.done:
        mig, _ = T.migration_step(mig)
    st, _ = T.migration_finish(mig)
    _, after, found3, _ = T.lookup(cfg, st, x)
    assert found3.all() and torch.equal(after, out)


def test_surrogate_create_elastic_and_resize(ref):
    """An elastic cache carries the reference's ring; ``resize`` is
    ``dht_resize`` with the config following the shard count."""
    cfg = _scfg(T)
    st = T.surrogate_create(cfg, elastic=True, n_virtual=16, device="cpu")
    want = J.surrogate_create(_scfg(J), elastic=True, n_virtual=16)
    np.testing.assert_array_equal(st.ring.positions.numpy(),
                                  np.asarray(want.ring.positions))
    assert T.surrogate_create(cfg, device="cpu").ring is None
    _, a = _port(ref)
    _, b = _port(ref)
    cfg2, a, sa = t_surrogate.resize(cfg, a, 8, batch=64)
    b, sb = T.dht_resize(b, 8, batch=64)
    assert cfg2.dht.n_shards == 8 and cfg2.dht == a.cfg and sa == sb
    for k, v in _snapshot(a).items():
        np.testing.assert_array_equal(v, _snapshot(b)[k], k)
