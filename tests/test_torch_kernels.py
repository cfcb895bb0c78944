"""The port's plain kernel versions (what the CPU path runs, and what each
CUDA kernel is held against on the card) against the JAX package's Pallas
kernels in interpret mode, bit for bit.  Same seeded numpy inputs on both
sides; words compared as uint32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DHTConfig as JConfig
from repro.core import dht_create as j_create
from repro.core import dht_write as j_write
from repro.core.hashing import base_bucket as j_base_bucket
from repro.core.hashing import checksum32 as j_checksum32
from repro.core.hashing import hash64 as j_hash64
from repro.core.hashing import probe_indices as j_probe_indices
from repro.core.op_engine import _probe_window as j_probe_window
from repro.kernels.apply_kernel import shard_apply_pallas
from repro.kernels.hash_kernel import hash64_pallas
from repro.kernels.route_kernel import route_pack_pallas, route_unpack_pallas
from repro_torch.kernels import ops, ref


def _words(rng, n, w):
    return rng.integers(0, 2**32, size=(n, w), dtype=np.uint64).astype(
        np.uint32)


def _t(a):
    """uint32 numpy -> int32 bit-view torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u(t):
    """torch int32 bit-view -> uint32 numpy."""
    return t.cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("n", [1, 7, 300])
@pytest.mark.parametrize("kw", [4, 20, 33])
def test_hash64_matches_pallas(n, kw):
    keys = _words(np.random.default_rng(n * 31 + kw), n, kw)
    expect = np.asarray(hash64_pallas(jnp.asarray(keys), interpret=True))
    np.testing.assert_array_equal(_u(ref.hash64(_t(keys))), expect)
    np.testing.assert_array_equal(_u(ops.hash64(_t(keys))), expect)


@pytest.mark.parametrize("n,rows,width", [(1, 16, 1), (80, 64, 22),
                                          (37, 96, 48), (50, 40, 28)])
def test_route_pack_matches_pallas(n, rows, width):
    """Fill rows (inv == -1), more rows than items and ragged widths."""
    rng = np.random.default_rng(rows + width)
    mat = _words(rng, n, width)
    inv = rng.integers(-1, n, size=rows).astype(np.int32)
    inv[:3] = -1
    fill = _words(rng, 1, width)[0]
    expect = np.asarray(route_pack_pallas(
        jnp.asarray(mat), jnp.asarray(inv), jnp.asarray(fill),
        interpret=True))
    out = ops.route_pack(_t(mat), torch.from_numpy(inv), _t(fill))
    np.testing.assert_array_equal(_u(out), expect)


@pytest.mark.parametrize("n,rows,width", [(1, 16, 1), (80, 64, 22),
                                          (61, 32, 28)])
def test_route_unpack_matches_pallas(n, rows, width):
    """Overflowed items (kept == 0) get the fill row."""
    rng = np.random.default_rng(rows * width)
    buf = _words(rng, rows, width)
    slot = rng.integers(0, rows, size=n).astype(np.int32)
    kept = rng.integers(0, 2, size=n).astype(np.int32)
    kept[0] = 0
    fill = _words(rng, 1, width)[0]
    expect = np.asarray(route_unpack_pallas(
        jnp.asarray(buf), jnp.asarray(slot), jnp.asarray(kept),
        jnp.asarray(fill), interpret=True))
    out = ops.route_unpack(_t(buf), torch.from_numpy(slot),
                           torch.from_numpy(kept), _t(fill))
    np.testing.assert_array_equal(_u(out), expect)


def _apply_case(n_probe, seed):
    """A one-shard slab written by the JAX package, then roughened: some
    buckets INVALID, some emptied, some checksums corrupted.  Queries mix
    stored keys and fresh keys; one window starts at B - n_probe."""
    rng = np.random.default_rng(seed)
    cfg = JConfig(n_shards=1, buckets_per_shard=128, n_probe=n_probe)
    keys = _words(rng, 96, cfg.key_words)
    vals = _words(rng, 96, cfg.val_words)
    st, _ = j_write(j_create(cfg), jnp.asarray(keys), jnp.asarray(vals))
    sk, sv = np.array(st.keys[0]), np.array(st.vals[0])
    sm, sc = np.array(st.meta[0]), np.array(st.csum[0])
    live = np.nonzero(sm & 1)[0]
    sm[live[0::7]] |= 2                       # INVALID
    sm[live[3::11]] = 0                       # emptied
    sc[live[5::9]] ^= 1                       # corrupted checksum
    q = np.concatenate([keys[:40], _words(rng, 16, cfg.key_words),
                        keys[40:48]])
    _, lo = j_hash64(jnp.asarray(q))
    base = np.array(j_base_bucket(lo, cfg.buckets_per_shard, n_probe))
    base[-1] = cfg.buckets_per_shard - n_probe
    return sk, sv, sm, sc, q, base


@pytest.mark.parametrize("n_probe,seed", [(6, 0), (6, 1), (1, 2), (4, 3)])
def test_shard_apply_matches_pallas_and_engine(n_probe, seed):
    sk, sv, sm, sc, q, base = _apply_case(n_probe, seed)
    j = [jnp.asarray(a) for a in (sk, sv, sm, sc, q, base)]
    v_p, f_p, w_p, k_p = shard_apply_pallas(*j, n_probe=n_probe,
                                            interpret=True)
    val, found, rsel, wsel, wkind = ops.shard_apply(
        _t(sk), _t(sv), _t(sm), _t(sc), _t(q), torch.from_numpy(base),
        n_probe)
    np.testing.assert_array_equal(_u(val), np.asarray(v_p))
    np.testing.assert_array_equal(found.numpy() == 1, np.asarray(f_p))
    np.testing.assert_array_equal(wsel.numpy(), np.asarray(w_p))
    np.testing.assert_array_equal(wkind.numpy(), np.asarray(k_p))

    # the extra outputs against the JAX engine's own probe: the selected
    # candidate, and "selected but checksum-failed" as found == -1
    idx = j_probe_indices(j[5], n_probe)
    win = {"keys": j[0][idx], "vals": j[1][idx], "meta": j[2][idx],
           "csum": j[3][idx]}
    has, sel, pval, stored = j_probe_window(win, j[4])
    ok = j_checksum32(j[4], pval) == stored
    tri = np.where(np.asarray(has), np.where(np.asarray(ok), 1, -1), 0)
    np.testing.assert_array_equal(found.numpy(), tri)
    np.testing.assert_array_equal(rsel.numpy(), np.asarray(sel))
    assert (tri == -1).any() and (tri == 1).any() and (tri == 0).any()


def test_shard_apply_checksum_reject_no_fallthrough():
    """A corrupted selected bucket reads as not-found (found == -1) even
    when a later candidate holds the same key with a valid checksum; the
    write lane still reports the same-key UPDATE slot."""
    from repro_torch.core.hashing import checksum32
    from repro_torch.core.op_engine import W_UPDATE

    rng = np.random.default_rng(5)
    kw, vw, b, p = 20, 26, 16, 6
    key = _words(rng, 1, kw)
    sk = np.zeros((b, kw), np.uint32)
    sv = _words(rng, b, vw)
    sm = np.zeros(b, np.uint32)
    sk[3] = sk[5] = key[0]
    sm[3] = sm[5] = 1 | (1 << 8)
    sc = _u(checksum32(_t(sk), _t(sv)))
    sc[3] ^= 1
    base = np.array([2], np.int32)
    args = [jnp.asarray(a) for a in (sk, sv, sm, sc, key, base)]
    v_p, f_p, w_p, k_p = shard_apply_pallas(*args, n_probe=p, interpret=True)
    val, found, rsel, wsel, wkind = ops.shard_apply(
        _t(sk), _t(sv), _t(sm), _t(sc), _t(key), torch.from_numpy(base), p)
    assert int(found[0]) == -1 and int(rsel[0]) == 1
    assert not bool(f_p[0])
    assert int(wsel[0]) == int(w_p[0]) == 1
    assert int(wkind[0]) == int(k_p[0]) == W_UPDATE
    np.testing.assert_array_equal(_u(val), np.asarray(v_p))

