"""The port's membership changes (``shard_leave``, ``shard_join``,
``dht_resize``, ``adopt_ring``) against the JAX package's, on the CPU,
bit for bit.

The reference runs once, in the module fixture ``ref``: a table of S=8,
B=1024 on a ring, 256 keys, loses shard 2, takes it back and shrinks
to 4 shards, every migration in steps of 96 rows (one step shape: each
new shape costs the reference's eager rounds seconds of compiling); a
modulo-placed table of the same shape adopts a ring.  The reference
fills its tables through ``jax.jit`` (with nothing dropped, the same
slab words as an eager fill).  The port starts from the reference's
slab words and makes the same calls; the plans, the stats and the slab
words after every change are the reference's, and the reference's own
assertions (``tests/test_membership.py``) hold on the port's results.
The grow, with dual reads, is tests/test_torch_migrate.py's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in an xdist worker)

import repro.core as J
from repro_torch import core as T
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.layout import INVALID, OCCUPIED

KW, VW = 20, 26
N = 256
BATCH = 96
SLAB = ("keys", "vals", "meta", "csum")

_jwrite = jax.jit(lambda st, k, v: J.dht_write(st, k, v)[0])


def _kv(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2**31, size=(n, KW)).astype(np.uint32),
            rng.integers(0, 2**31, size=(n, VW)).astype(np.uint32))


def _jslab(st) -> dict:
    return {k: np.array(getattr(st, k)) for k in SLAB}


def _snapshot(ts) -> dict:
    return {k: v.copy() for k, v in state_to_numpy(ts).items()}


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _live(slab) -> int:
    m = slab["meta"]
    return int((((m & OCCUPIED) != 0) & ((m & INVALID) == 0)).sum())


def _ints(d: dict) -> dict:
    return {k: int(v) for k, v in d.items()}


def _assert_slab(got: dict, want: dict, what: str):
    for k in SLAB:
        np.testing.assert_array_equal(got[k], want[k], f"{what}: {k}")


@pytest.fixture(scope="module")
def ref():
    cfg = J.DHTConfig(n_shards=8, buckets_per_shard=1024)
    keys, vals = _kv(N, seed=4)
    st = _jwrite(J.dht_create(cfg, J.ring_create(8)), jnp.asarray(keys),
                 jnp.asarray(vals))
    r = {"cfg": cfg, "keys": keys, "vals": vals, "init": _jslab(st)}
    r["plan_leave"] = J.plan_migration(st, J.ring_leave(st.ring, 2),
                                       st.cfg).src
    st, r["leave_stats"] = J.shard_leave(st, 2, batch=BATCH)
    r["leave"] = _jslab(st)
    st, r["join_stats"] = J.shard_join(st, 2, batch=BATCH)
    r["join"] = _jslab(st)
    r["plan_shrink"] = J.plan_migration(st, J.ring_resize(st.ring, 4)).src
    st, r["shrink_stats"] = J.dht_resize(st, 4, batch=BATCH)
    r["shrink"] = _jslab(st)

    akeys, avals = _kv(N, seed=5)
    st = _jwrite(J.dht_create(cfg), jnp.asarray(akeys), jnp.asarray(avals))
    r["adopt_init"], r["adopt_keys"], r["adopt_vals"] = (
        _jslab(st), akeys, avals)
    st, r["adopt_stats"] = J.adopt_ring(st, batch=BATCH)
    r["adopt"] = _jslab(st)
    return r


@pytest.fixture(scope="module")
def port(ref):
    """The port's chain from the reference's starting words: each
    change's plan, stats, slab and read of every key."""
    st = state_from_numpy(dataclasses.asdict(ref["cfg"]),
                          *(ref["init"][k] for k in SLAB),
                          ring=T.ring_create(8), device="cpu")
    keys = _t(ref["keys"])
    out = {}

    def change(name, new_ring, fn):
        nonlocal st
        plan = T.plan_migration(st, new_ring)
        st, stats = fn(st)
        _, vals, found, _ = T.dht_read(st, keys)
        out[name] = {"src": plan.src.numpy(), "stats": stats,
                     "slab": _snapshot(st), "vals": vals.numpy().view(
                         np.uint32).copy(), "found": found.numpy(),
                     "occupancy": T.occupancy(st).numpy(),
                     "rows": st.flat_meta.shape[0],
                     "n_shards": st.cfg.n_shards}

    change("leave", T.ring_leave(st.ring, 2),
           lambda s: T.shard_leave(s, 2, batch=BATCH))
    change("join", T.ring_join(st.ring, 2),
           lambda s: T.shard_join(s, 2, batch=BATCH))
    change("shrink", T.ring_resize(st.ring, 4),
           lambda s: T.dht_resize(s, 4, batch=BATCH))
    return out


def test_shard_leave_then_join_rebalances_in_place(ref, port):
    n_live = _live(ref["init"])
    got = port["leave"]
    np.testing.assert_array_equal(got["src"], ref["plan_leave"])
    assert got["stats"] == _ints(ref["leave_stats"])
    assert got["stats"]["inplace"] and 0 < got["stats"]["moved"] < n_live // 2
    _assert_slab(got["slab"], ref["leave"], "after the leave")
    assert got["occupancy"][2] == 0.0, "the leaver's slab drains"
    assert _live(got["slab"]) == n_live
    assert got["found"].all() and (got["vals"] == ref["vals"]).all()
    # only the leaver's entries moved (its rows, shard-major)
    assert ((got["src"] // 1024) == 2).all()

    got = port["join"]
    assert got["stats"] == _ints(ref["join_stats"])
    _assert_slab(got["slab"], ref["join"], "after the join")
    assert got["occupancy"][2] > 0.0, "the joiner recaptures entries"
    assert _live(got["slab"]) == n_live
    assert got["found"].all() and (got["vals"] == ref["vals"]).all()


def test_resize_down_preserves_all_live_entries(ref, port):
    """8 -> 4 shards: every live entry survives, only part of the table
    moves, and the evacuated rows are freed."""
    n_live = _live(ref["init"])
    got = port["shrink"]
    np.testing.assert_array_equal(got["src"], ref["plan_shrink"])
    assert got["stats"] == _ints(ref["shrink_stats"])
    _assert_slab(got["slab"], ref["shrink"], "after the shrink")
    assert got["n_shards"] == 4 and got["rows"] == 4 * 1024 + 1
    assert _live(got["slab"]) == n_live
    stats = got["stats"]
    assert stats["evicted_at_dest"] == 0 and stats["inplace"]
    assert 0 < stats["moved"] < n_live
    assert got["found"].all() and (got["vals"] == ref["vals"]).all()


def test_adopt_ring_migrates_modulo_placement(ref):
    ts = state_from_numpy(dataclasses.asdict(ref["cfg"]),
                          *(ref["adopt_init"][k] for k in SLAB),
                          device="cpu")
    ts, ms = T.adopt_ring(ts, batch=BATCH)
    assert ts.ring is not None and ms["moved"] > 0
    assert ms == _ints(ref["adopt_stats"])
    _assert_slab(state_to_numpy(ts), ref["adopt"], "after the adoption")
    _, out, found, _ = T.dht_read(ts, _t(ref["adopt_keys"]))
    assert found.all()
    np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                  ref["adopt_vals"])
    with pytest.raises(ValueError, match="already has a ring"):
        T.adopt_ring(ts)
    with pytest.raises(ValueError, match="needs a ring"):
        T.shard_join(T.with_ring(ts, None), 0)
