"""The port's online resharding (``repro_torch.core.migrate``) and its
dual-epoch reads against the JAX package's, on the CPU, bit for bit.

The reference runs its scenarios once, in the module fixture ``ref``,
and keeps numpy arrays; the port starts from the reference's slab words
(``convert.state_from_numpy`` with the port's ring, which equals the
reference's word for word: tests/test_torch_membership.py) and makes the
same calls.  One table (S=4, B=1024, 256 keys) grows to 8 shards in 2
steps of 96 rows, with a dual read after each step and writes of a
quarter of the keys each in the new epoch before and between the steps;
a copy with corrupted checksums is resized.  (The leave, the join, the
shrink and the ring adoption are tests/test_torch_reshard.py's; each
new table shape costs the reference's eager rounds seconds of
compiling, so the scenarios are split between the files.)  The
reference fills its tables through ``jax.jit``: its traced capacity
differs from the eager one, but with nothing dropped the slab words are
the same.

Held equal: migration plans (``plan.src``), the stats dicts, the slab
words after every migration, read outputs and found flags, and for each
mid-migration dual read its values, found flags, counts (``hits``,
``hits_old_epoch``, ...) and both epochs' slabs.  The reference's own
tests (``tests/test_membership.py``) are asserted on the port's results.
Port-only: the frozen old epoch is never written while a migration runs
(the port updates tables in place; ``migration_begin`` copies), the
fused dual read is one dispatch and equals the sequential fallback, and
a rebuild migration reads through that fallback.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro_torch import core as T
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.dht import _dht_read_dual_seq as t_dual_seq
from repro_torch.core.layout import INVALID, OCCUPIED
from repro_torch.obs import metrics as t_metrics

KW, VW = 20, 26
N = 256                 # keys of every table, rows of every round
BATCH = 96              # rows a migration step: the grow takes 2
SLAB = ("keys", "vals", "meta", "csum")
BEFORE = np.arange(N) % 4 == 0      # re-written before the first step
BETWEEN = np.arange(N) % 4 == 1     # re-written after the first step


def _kv(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2**31, size=(n, KW)).astype(np.uint32),
            rng.integers(0, 2**31, size=(n, VW)).astype(np.uint32))


def _expected(vals):
    """The values the main table holds after the grow's writes."""
    out = vals.copy()
    out[BEFORE] += 7
    out[BETWEEN] += 9
    return out


_jwrite = jax.jit(lambda st, k, v, m: J.dht_write(st, k, v, m)[0])
_jread = jax.jit(lambda st, k: J.dht_read(st, k))


def _jslab(st) -> dict:
    return {k: np.array(getattr(st, k)) for k in SLAB}


def _u(x: torch.Tensor) -> np.ndarray:
    a = x.detach().cpu().numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32
                             else a).copy())


def _port(cfg, slab, ring=None):
    """The port's table holding ``slab``'s words under ``ring``."""
    return state_from_numpy(dataclasses.asdict(cfg),
                            *(slab[k] for k in SLAB), ring=ring,
                            device="cpu")


def _snapshot(ts) -> dict:
    """The table's words now (``state_to_numpy`` views CPU buffers that
    later rounds update in place)."""
    return {k: v.copy() for k, v in state_to_numpy(ts).items()}


def _assert_slab(ts, slab, what):
    for k, v in state_to_numpy(ts).items():
        np.testing.assert_array_equal(v, slab[k], f"{what}: {k}")


def _ints(d: dict) -> dict:
    return {k: int(v) for k, v in d.items()}


def _live(slab) -> int:
    m = slab["meta"]
    return int((((m & OCCUPIED) != 0) & ((m & INVALID) == 0)).sum())


DUAL_LANES = ("hits", "misses", "mismatches", "dropped", "epoch",
              "wire_words", "hits_old_epoch", "bin_counts", "bin_max_load")


def _dual(vals, found, stats):
    """(vals, found, lanes) of the reference's dual read, as numpy."""
    return (np.array(vals), np.array(found),
            {k: np.array(stats[k]) for k in DUAL_LANES})


def _tdual(vals, found, stats):
    """(vals, found, lanes) of the port's dual read, as numpy."""
    return (_u(vals), _u(found),
            {k: _u(torch.as_tensor(stats[k])) for k in DUAL_LANES})


def _assert_dual(got, want, what):
    np.testing.assert_array_equal(got[0], want[0], f"{what}: vals")
    np.testing.assert_array_equal(got[1], want[1], f"{what}: found")
    for k in DUAL_LANES:
        np.testing.assert_array_equal(got[2][k], want[2][k], f"{what}: {k}")


# ---------------------------------------------------------------------------
# the reference's scenarios, each run once
# ---------------------------------------------------------------------------

def _ref_main():
    cfg = J.DHTConfig(n_shards=4, buckets_per_shard=1024)
    keys, vals = _kv(N)
    k, v = jnp.asarray(keys), jnp.asarray(vals)
    st = _jwrite(J.dht_create(cfg, J.ring_create(4)), k, v, jnp.ones(N, bool))
    r = {"cfg": cfg, "keys": keys, "vals": vals, "init": _jslab(st)}
    plan = J.plan_migration(st, J.ring_leave(st.ring, 1), st.cfg)
    r["plan_leave1"] = (plan.src, plan.n_live, plan.mig_cfg.n_shards)

    # a copy whose every checksum fails: the read flags it INVALID and
    # the resize moves nothing
    inv = J.DHTState(cfg, st.keys, st.vals, st.meta,
                     st.csum ^ jnp.uint32(0xDEADBEEF), st.ring)
    inv, _, found, _ = _jread(inv, k)
    r["inv_found"] = np.array(found)
    inv, r["inv_stats"] = J.dht_resize(inv, 8, batch=BATCH)
    r["inv_final"] = _jslab(inv)

    # grow to 8 with writes in the new epoch before and between the
    # steps, a dual read after each step
    mig = J.migration_begin(st, J.ring_resize(st.ring, 8), batch=BATCH)
    r["grow_src"] = mig.plan.src
    mig.new = _jwrite(mig.new, k, v + 7, jnp.asarray(BEFORE))
    r["steps"] = []
    while not mig.done:
        mig, step = J.migration_step(mig)
        if not r["steps"]:
            mig.new = _jwrite(mig.new, k, v + 9, jnp.asarray(BETWEEN))
        mig, out, found, ds = J.migration_read(mig, k)
        r["steps"].append({"step": _ints(step), "dual": _dual(out, found, ds),
                           "new": _jslab(mig.new), "old": _jslab(mig.old)})
    st, r["grow_stats"] = J.migration_finish(mig)
    r["grow"] = _jslab(st)
    return r


@pytest.fixture(scope="module")
def ref():
    return _ref_main()


@pytest.fixture(scope="module")
def grown(ref):
    """The port's grow of the table, run to its end: ``(state, stats,
    steps)``, each step's counts, dual read and both epochs' slabs."""
    ts = _port(ref["cfg"], ref["init"], T.ring_create(4))
    keys, vals = _t(ref["keys"]), ref["vals"]
    mig = T.migration_begin(ts, T.ring_resize(ts.ring, 8), batch=BATCH)
    assert mig.old is ts and mig.new.flat_keys is not ts.flat_keys
    np.testing.assert_array_equal(mig.plan.src.numpy(), ref["grow_src"])
    T.dht_write(mig.new, keys, _t(vals + 7), _t(BEFORE))
    steps = []
    while not mig.done:
        mig, step = T.migration_step(mig)
        if not steps:
            T.dht_write(mig.new, keys, _t(vals + 9), _t(BETWEEN))
        mig, out, found, ds = T.migration_read(mig, keys)
        steps.append({"step": step, "dual": _tdual(out, found, ds),
                      "new": _snapshot(mig.new), "old": _snapshot(mig.old)})
    st, stats = T.migration_finish(mig)
    return st, stats, steps


# ---------------------------------------------------------------------------
# the reference's tests (tests/test_membership.py), on the port, against
# the reference
# ---------------------------------------------------------------------------

def test_mid_migration_dual_read_never_loses_hits(ref, grown):
    """Every dual read between the steps finds every key with its latest
    value, part of them from the old epoch while both are live; values,
    flags, counts and both slabs equal the reference's."""
    _, stats, steps = grown
    assert len(steps) == len(ref["steps"]) >= 2
    want_vals = _expected(ref["vals"])
    for i, (got, want) in enumerate(zip(steps, ref["steps"])):
        assert got["step"] == want["step"]
        _assert_dual(got["dual"], want["dual"], f"step {i}")
        for k in SLAB:
            np.testing.assert_array_equal(got["new"][k], want["new"][k])
            np.testing.assert_array_equal(got["old"][k], want["old"][k])
        assert got["dual"][1].all()
        np.testing.assert_array_equal(got["dual"][0], want_vals)
    assert int(steps[0]["dual"][2]["hits_old_epoch"]) > 0
    assert stats == _ints(ref["grow_stats"])


def test_mid_migration_write_survives_stale_copy(ref, grown):
    """Keys written in the new epoch before and between the steps keep
    their new values (their stale copies are skipped), and the frozen old
    epoch stays word for word the table the migration began from (the
    port's buffer rule).  The grow keeps every live entry."""
    st, stats, steps = grown
    assert stats["skipped"] > 0
    assert stats["moved"] + stats["skipped"] == stats["n_planned"]
    assert stats["evicted_at_dest"] == 0 and stats["inplace"]
    for i, got in enumerate(steps):
        for k in SLAB:
            np.testing.assert_array_equal(got["old"][k], ref["init"][k],
                                          f"old epoch after step {i}: {k}")
    _assert_slab(st, ref["grow"], "after the grow")
    assert st.cfg.n_shards == 8 and st.keys.shape[0] == 8
    assert _live(state_to_numpy(st)) == _live(ref["init"])
    _, out, found, _ = T.dht_read(st, _t(ref["keys"]))
    assert found.all()
    np.testing.assert_array_equal(_u(out), _expected(ref["vals"]))


def test_plan_matches_owner_delta(ref):
    """The plan is exactly the live buckets whose owner on the new ring
    is not the row they sit in: under consistent hashing, leaving shard 1
    moves exactly its entries."""
    ts = _port(ref["cfg"], ref["init"], T.ring_create(4))
    plan = T.plan_migration(ts, T.ring_leave(ts.ring, 1), ts.cfg)
    src, n_live, rows = ref["plan_leave1"]
    np.testing.assert_array_equal(plan.src.numpy(), src)
    assert (plan.n_live, plan.mig_cfg.n_shards) == (n_live, rows)
    assert plan.src.dtype == torch.int64 and plan.inplace
    assert ((plan.src // 1024) == 1).all()


def test_invalid_entries_are_not_migrated(ref):
    ts = _port(ref["cfg"], ref["init"], T.ring_create(4))
    ts.flat_csum[:-1] ^= np.uint32(0xDEADBEEF).view(np.int32).item()
    ts, _, found, _ = T.dht_read(ts, _t(ref["keys"]))
    np.testing.assert_array_equal(found.numpy(), ref["inv_found"])
    assert not found.any()
    ts, ms = T.dht_resize(ts, 8, batch=BATCH)
    assert ms == _ints(ref["inv_stats"])
    assert ms["n_live"] == 0 and ms["moved"] == 0
    _assert_slab(ts, ref["inv_final"], "after the resize")


# ---------------------------------------------------------------------------
# port-only: the dual-read forms and the guards
# ---------------------------------------------------------------------------

def test_fused_dual_read_is_one_dispatch_and_equals_sequential(ref):
    """After the first step: the fused read is one dispatch at capacity
    2*cap, the sequential fallback two; their values, found flags and
    counts agree."""
    ts = _port(ref["cfg"], ref["init"], T.ring_create(4))
    mig = T.migration_begin(ts, T.ring_resize(ts.ring, 8), batch=BATCH)
    mig, _ = T.migration_step(mig)
    keys = _t(ref["keys"])
    with t_metrics.counting() as fused_n:
        _, _, vf, ff, sf = T.dht_read_dual(mig.new, mig.old, keys)
    with t_metrics.counting() as seq_n:
        _, _, vs, fs, ss = t_dual_seq(mig.new, mig.old, keys,
                                      torch.ones(N, dtype=torch.bool))
    assert fused_n.delta == 1 and seq_n.delta == 2
    assert torch.equal(vf, vs) and torch.equal(ff, fs) and ff.all()
    for k in ("hits", "misses", "hits_old_epoch", "epoch", "mismatches"):
        assert int(sf[k]) == int(ss[k]), k
    assert int(sf["hits_old_epoch"]) > 0
    # the sequential form's wire words are its two rounds' together
    assert int(ss["wire_words"]) > 0 and 0.0 <= float(ss["fill_frac"]) < 1.0


def test_rebuild_migration_reads_through_sequential_fallback(ref):
    """A rebuild (B 1024 -> 2048, window 6 -> 4) re-inserts every live
    entry; its epochs cannot share a round, so the dual reads take two,
    and every key stays found with its value throughout."""
    ts = _port(ref["cfg"], ref["init"], T.ring_create(4))
    new_cfg = dataclasses.replace(ts.cfg, buckets_per_shard=2048, n_probe=4)
    assert not T.dual_fusable(new_cfg, ts.cfg)
    mig = T.migration_begin(ts, T.ring_resize(ts.ring, 4), new_cfg,
                            batch=BATCH)
    assert not mig.plan.inplace and mig.plan.n_moved == _live(ref["init"])
    keys = _t(ref["keys"])
    while not mig.done:
        mig, _ = T.migration_step(mig)
        with t_metrics.counting() as n:
            mig, out, found, ds = T.migration_read(mig, keys)
        assert n.delta == 2 and found.all()
        assert (_u(out) == ref["vals"]).all()
    ts, ms = T.migration_finish(mig)
    assert ms["moved"] == ms["n_live"] and not ms["inplace"]
    assert ts.cfg == new_cfg and ts.keys.shape[1] == 2048
    _, out, found, _ = T.dht_read(ts, keys)
    assert found.all() and (_u(out) == ref["vals"]).all()


def test_dual_round_guards():
    """A dual-epoch round is read-only and needs the esel lane; with_ring
    attaches without copying; dht_free drops only this state's buffers;
    a ring wider than the table does not fit."""
    cfg = T.DHTConfig(n_shards=2, buckets_per_shard=64)
    st = T.dht_create(cfg, T.ring_create(2), device="cpu")
    keys = torch.zeros((4, KW), dtype=torch.int32)
    with pytest.raises(ValueError, match="esel"):
        T.dht_execute(st, T.read_ops(keys), kinds=("read",), prev=st)
    ops = T.OpBatch(keys=keys, valid=torch.ones(4, dtype=torch.bool),
                    vals=torch.zeros((4, VW), dtype=torch.int32),
                    esel=torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="read-only"):
        T.dht_execute(st, ops, kinds=("write",), prev=st)
    other = T.with_ring(st, None)
    assert other.flat_keys is st.flat_keys and other.ring is None
    T.dht_free(other)
    assert other.flat_keys.numel() == 0 and st.flat_keys.numel() > 0
    with pytest.raises(ValueError, match="does not fit"):
        T.dht_create(cfg, T.ring_create(3), device="cpu")
    with pytest.raises(RuntimeError, match="in flight"):
        T.migration_finish(_pending(cfg))


def _pending(cfg):
    """A migration with one planned entry and no step taken."""
    st = T.dht_create(cfg, T.ring_create(2), device="cpu")
    g = torch.Generator().manual_seed(0)
    keys = torch.randint(-2**31, 2**31, (64, KW), generator=g,
                         dtype=torch.int64).to(torch.int32)
    T.dht_write(st, keys, torch.zeros((64, VW), dtype=torch.int32))
    return T.migration_begin(st, T.ring_leave(st.ring, 0), batch=8)
