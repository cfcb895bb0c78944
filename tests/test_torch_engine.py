"""The slice as a whole on the CPU: the port's op-engine and DHT wrappers
against the JAX package on seeded write, read, 95/5 mixed and migrate
streams (S=4, B=256).  After every round the slab words, the per-item
values/found/codes and every ``estats`` lane must be identical, and each
call must be ONE dispatch round.  Plus the word representation (layout)
and key rounding parity."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in an xdist worker)

import repro.core as J
from repro.core.layout import DHTState as JState
from repro.core.layout import pack_floats as j_pack_floats
from repro.core.layout import shard_watermark as j_watermark
from repro.core.neighbors import round_significant as j_round
from repro_torch import core as T
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.layout import shard_watermark, unpack_floats
from repro_torch.core.neighbors import round_significant
from repro_torch.obs import counting

KW, VW = 20, 26
ESTATS = ("mismatches", "rounds", "lock_tokens", "dropped", "epoch",
          "wire_words", "wire_send_words", "wire_reply_words", "fill_frac",
          "dispatch_rounds", "n_shards", "capacity", "bin_counts",
          "bin_max_load", "bin_imbalance", "hot_frac", "fallback_reads")
L1_META = ("bucket_gen", "wmark_pre", "wmark_post")


def _words(rng, n, w):
    return rng.integers(0, 2**32, size=(n, w), dtype=np.uint64).astype(
        np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _np(x):
    x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.int32 and x.ndim > 1 else x


def _pair(cfg_kw):
    jcfg = J.DHTConfig(**cfg_kw)
    js = J.dht_create(jcfg)
    ts = state_from_numpy(dataclasses.asdict(jcfg), *(
        np.asarray(getattr(js, k)) for k in ("keys", "vals", "meta", "csum")),
        device="cpu")
    return js, ts


def _assert_tables_equal(js, ts):
    tn = state_to_numpy(ts)
    for k, v in tn.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(js, k)), k)


def _assert_stats_equal(jes, tes, keys):
    for k in keys:
        a, b = np.atleast_1d(jes[k]), np.atleast_1d(_np(tes[k]))
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(b.astype(a.dtype).view(np.uint8),
                                      a.view(np.uint8), k)


def _execute_both(js, ts, kind, keys, vals=None, op=None, l1_meta=False):
    kinds = (kind,) if op is None else ("read", "write")
    if op is not None:
        jops = J.mixed_ops(jnp.asarray(op), jnp.asarray(keys),
                           jnp.asarray(vals))
        tops = T.mixed_ops(torch.from_numpy(op), _t(keys), _t(vals))
    elif kind == "read":
        jops, tops = J.read_ops(jnp.asarray(keys)), T.read_ops(_t(keys))
    else:
        mk = {"write": (J.write_ops, T.write_ops),
              "migrate": (J.migrate_ops, T.migrate_ops)}[kind]
        jops = mk[0](jnp.asarray(keys), jnp.asarray(vals))
        tops = mk[1](_t(keys), _t(vals))
    js, _, jv, jf, jc, jes = J.dht_execute(js, jops, kinds=kinds,
                                           l1_meta=l1_meta)
    with counting() as c:
        ts, _, tv, tf, tc, tes = T.dht_execute(ts, tops, kinds=kinds,
                                               l1_meta=l1_meta)
    assert c.delta == 1
    _assert_tables_equal(js, ts)
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))
    np.testing.assert_array_equal(_np(tf), np.asarray(jf))
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    _assert_stats_equal(jes, tes, ESTATS + (L1_META if l1_meta else ()))
    assert set(tes) == set(jes)
    return js, ts, tes


def test_engine_streams_match_reference():
    """write -> read (all found) -> corrupted read -> 95/5 mixed ->
    migrate, one engine round each, state carried across."""
    rng = np.random.default_rng(0)
    js, ts = _pair(dict(n_shards=4, buckets_per_shard=256))
    keys, vals = _words(rng, 600, KW), _words(rng, 600, VW)
    js, ts, es = _execute_both(js, ts, "write", keys, vals)
    assert es["rounds"] > 1                 # slot conflicts re-probed
    js, ts, es = _execute_both(js, ts, "read", keys)
    # corrupt some checksums: reads flag those buckets INVALID
    csum = np.array(js.csum)
    csum[0, :64] ^= 1
    js = JState(js.cfg, js.keys, js.vals, js.meta, jnp.asarray(csum))
    ts.flat_csum[:64] ^= 1
    js, ts, es = _execute_both(js, ts, "read", keys)
    assert int(es["mismatches"]) > 0
    op = (rng.random(600) < 0.05).astype(np.int32)       # 95/5 read/write
    k2 = np.concatenate([keys[:300], _words(rng, 300, KW)])
    v2 = _words(rng, 600, VW)
    js, ts, _ = _execute_both(js, ts, "mixed", k2, v2, op=op)
    js, ts, es = _execute_both(js, ts, "migrate", k2, v2)


def test_fixed_capacity_drops_and_retries_match():
    """An explicit capacity overflows; ``dht_write(max_retries=2)``
    re-issues the dropped rows exactly as the reference does."""
    rng = np.random.default_rng(16)
    kw = dict(n_shards=4, buckets_per_shard=256, capacity=16)
    js, ts = _pair(kw)
    keys, vals = _words(rng, 200, KW), _words(rng, 200, VW)
    js, jst = J.dht_write(js, jnp.asarray(keys), jnp.asarray(vals),
                          max_retries=2)
    ts, tst = T.dht_write(ts, _t(keys), _t(vals), max_retries=2)
    _assert_tables_equal(js, ts)
    _assert_stats_equal(jst, tst, ("inserted", "updated", "evicted",
                                   "dropped", "rounds", "wire_words",
                                   "code", "fill_frac"))
    js, jv, jf, jrs = J.dht_read(js, jnp.asarray(keys))
    ts, tv, tf, trs = T.dht_read(ts, _t(keys))
    np.testing.assert_array_equal(_np(tf), np.asarray(jf))
    _assert_stats_equal(jrs, trs, ("hits", "misses", "dropped",
                                   "mismatches", "bin_counts"))


def test_mixed_batch_equals_sequential_snapshot():
    """One mixed round == read the round-start snapshot, then write
    (modelled on the reference's tests/test_op_engine.py)."""
    rng = np.random.default_rng(7)
    cfg = T.DHTConfig(n_shards=8, buckets_per_shard=512)
    st0 = T.dht_create(cfg, device="cpu")
    keys, vals = _t(_words(rng, 128, KW)), _t(_words(rng, 128, VW))
    st0, _ = T.dht_write(st0, keys, vals)
    new_k, new_v = _t(_words(rng, 64, KW)), _t(_words(rng, 64, VW))
    some_k = torch.cat([keys[:32], new_k[:16]])
    op = torch.cat([torch.full((48,), T.OP_READ, dtype=torch.int32),
                    torch.full((64,), T.OP_WRITE, dtype=torch.int32)])
    ops = T.mixed_ops(op, torch.cat([some_k, new_k]),
                      torch.cat([torch.zeros((48, VW), dtype=torch.int32),
                                 new_v]))
    st_a, _, val_a, found_a, code_a, _ = T.dht_execute(
        st0.clone(), ops, kinds=("read", "write"))
    st_b, val_b, found_b, _ = T.dht_read(st0.clone(), some_k)
    st_b, ws = T.dht_write(st_b, new_k, new_v)
    assert torch.equal(val_a[:48], val_b)
    assert torch.equal(found_a[:48], found_b)
    assert torch.equal(code_a[48:], ws["code"])
    for k in ("keys", "vals", "meta", "csum"):
        assert torch.equal(getattr(st_a, k), getattr(st_b, k)), k


def test_migrate_equals_read_then_write_if_absent():
    rng = np.random.default_rng(9)
    cfg = T.DHTConfig(n_shards=8, buckets_per_shard=512)
    st0 = T.dht_create(cfg, device="cpu")
    keys, vals = _t(_words(rng, 128, KW)), _t(_words(rng, 128, VW))
    st0, _ = T.dht_write(st0, keys, vals)
    fk, fv = _t(_words(rng, 32, KW)), _t(_words(rng, 32, VW))
    mk = torch.cat([keys[:32], fk])
    mv = torch.cat([vals[:32] + 11, fv])
    st_a, _, val_a, found_a, code_a, _ = T.dht_execute(
        st0.clone(), T.migrate_ops(mk, mv), kinds=("migrate",))
    st_b, val_b, found_b, _ = T.dht_read(st0.clone(), mk)
    st_b, _ = T.dht_write(st_b, mk, mv, valid=~found_b)
    assert torch.equal(found_a, found_b) and torch.equal(val_a, val_b)
    for k in ("keys", "vals", "meta", "csum"):
        assert torch.equal(getattr(st_a, k), getattr(st_b, k)), k
    assert int((code_a == T.W_SKIP).sum()) == 32
    assert int((code_a == T.W_INSERT).sum()) == 32


@pytest.mark.parametrize("mode", ["fine", "coarse"])
def test_locked_modes_match_reference(mode):
    """The fine and coarse locking schedules (the paper's other two
    designs) against the JAX engine: write -> read -> corrupted read (no
    checksum in these modes: still found, no mismatch) -> 95/5 mixed ->
    migrate, with the same slab words, codes, ``rounds`` and
    ``lock_tokens`` (summed over the virtual shards' own round counts)."""
    rng = np.random.default_rng(21)
    js, ts = _pair(dict(n_shards=4, buckets_per_shard=256, mode=mode))
    keys, vals = _words(rng, 300, KW), _words(rng, 300, VW)
    js, ts, es = _execute_both(js, ts, "write", keys, vals)
    assert es["rounds"] > 1 and es["lock_tokens"] >= 2 * 4 * 1
    js, ts, es = _execute_both(js, ts, "read", keys)
    assert es["lock_tokens"] == 2 * 4 and es["rounds"] == 0
    csum = np.array(js.csum)
    csum[0, :64] ^= 1
    js = JState(js.cfg, js.keys, js.vals, js.meta, jnp.asarray(csum))
    ts.flat_csum[:64] ^= 1
    js, ts, es = _execute_both(js, ts, "read", keys)
    assert int(es["mismatches"]) == 0
    op = (rng.random(300) < 0.05).astype(np.int32)
    k2 = np.concatenate([keys[:150], _words(rng, 150, KW)])
    v2 = _words(rng, 300, VW)
    js, ts, _ = _execute_both(js, ts, "mixed", k2, v2, op=op)
    js, ts, es = _execute_both(js, ts, "migrate", k2, v2)
    assert es["rounds"] > 1


def test_coarse_serializes_more_than_fine():
    """The same write batch takes more locked rounds under the coarse
    lock than under the fine one, and tokens follow the rounds."""
    rng = np.random.default_rng(22)
    keys, vals = _t(_words(rng, 200, KW)), _t(_words(rng, 200, VW))
    out = {}
    for mode in ("fine", "coarse"):
        st = T.dht_create(T.DHTConfig(n_shards=4, buckets_per_shard=256,
                                      mode=mode), device="cpu")
        st, ws = T.dht_write(st, keys, vals)
        out[mode] = (int(ws["rounds"]), int(ws["lock_tokens"]))
    assert out["fine"][0] < out["coarse"][0]
    # coarse: each shard takes as many rounds as it got writes
    assert out["coarse"][1] == 2 * 200


@pytest.mark.parametrize("mode", ["lockfree", "coarse"])
def test_l1_meta_round_matches_reference(mode):
    """``l1_meta=True`` on a mixed round: the serving buckets'
    generations and every shard's watermark before and after the round
    equal the JAX engine's, and the reply leg counts 3 more lanes."""
    rng = np.random.default_rng(12)
    js, ts = _pair(dict(n_shards=4, buckets_per_shard=256, mode=mode))
    keys, vals = _words(rng, 300, KW), _words(rng, 300, VW)
    js, ts, es = _execute_both(js, ts, "write", keys, vals, l1_meta=True)
    assert (_np(es["wmark_post"]) != _np(es["wmark_pre"])).all()
    op = (rng.random(300) < 0.1).astype(np.int32)
    k2 = np.concatenate([keys[:200], _words(rng, 100, KW)])
    v2 = _words(rng, 300, VW)
    js, ts, es = _execute_both(js, ts, "mixed", k2, v2, op=op, l1_meta=True)
    assert (_np(es["bucket_gen"]) > 0).any()
    _, _, _, _, _, plain = T.dht_execute(
        ts.clone(), T.read_ops(_t(keys)), kinds=("read",))
    _, _, _, _, _, meta = T.dht_execute(
        ts.clone(), T.read_ops(_t(keys)), kinds=("read",), l1_meta=True)
    assert (meta["wire_reply_words"] - plain["wire_reply_words"]
            == 3 * 4 * meta["capacity"])


@pytest.mark.parametrize("what,exc,match", [
    pytest.param("elide_self", ValueError, "elision needs",
                 id="elide_self"),
    pytest.param("prev", ValueError, "esel", id="prev"),
    pytest.param("axis_name", TypeError, "ProcessGroup", id="axis_name")])
def test_later_slices_raise(what, exc, match):
    """``prev`` makes a dual-epoch round, which needs the ``esel`` lane
    (as the reference asserts).  ``axis_name`` must be a process group
    (a mesh axis name is not), and ``elide_self`` needs one, as the
    reference asserts (``op_engine.py:760-761``)."""
    cfg = T.DHTConfig(n_shards=2, buckets_per_shard=64)
    st = T.dht_create(cfg, device="cpu")
    ops = T.read_ops(torch.zeros((4, KW), dtype=torch.int32))
    with pytest.raises(exc, match=match):
        T.dht_execute(st, ops, kinds=("read",), **{what: True})


# ---------------------------------------------------------------------------
# word representation and key rounding
# ---------------------------------------------------------------------------

def test_pack_floats_round_trip_and_reference_words():
    x = np.random.default_rng(3).normal(size=(17, 10)).astype(np.float32)
    x[0, :3] = [0.0, -0.0, np.inf]
    for n_words in (20, 26, 7):
        w = T.pack_floats(torch.from_numpy(x), n_words)
        np.testing.assert_array_equal(
            _np(w), np.asarray(j_pack_floats(jnp.asarray(x), n_words)))
    back = unpack_floats(T.pack_floats(torch.from_numpy(x), 20), 10)
    np.testing.assert_array_equal(back.numpy().view(np.uint32),
                                  x.view(np.uint32))


def test_shard_watermark_wraps_like_uint32():
    meta = np.full((2, 300), 0xFFFFFF01, np.uint32)
    meta[1, ::3] = 7
    np.testing.assert_array_equal(
        shard_watermark(_t(meta)).numpy(),
        np.asarray(j_watermark(jnp.asarray(meta))).astype(np.int64))


def _decade_band(sig):
    """Inputs within +-64 ulps of every power of ten, both signs."""
    p = np.array([np.float32(10.0 ** k) for k in range(-37, 38)], np.float32)
    band = (p.view(np.int32)[:, None] + np.arange(-64, 65)[None, :])
    band = band.astype(np.int32).view(np.float32).ravel()
    return np.concatenate([band, -band])


@pytest.mark.parametrize("sig", [3, 4])
def test_round_significant_matches_reference(sig):
    """Exact outside the +-64-ulp band around each 10^e (1e-30..1e30,
    both signs, edge values); inside the band the residue of F1
    (ROADMAP.md) is pinned: 6 of 19,350 (sig 3) and 2 of 19,350 (sig 4)
    words differ, each by one lattice step of a decade boundary."""
    rng = np.random.default_rng(sig)
    n = 200_000
    x = (10.0 ** rng.uniform(-30, 30, n)
         * rng.choice([-1, 1], n)).astype(np.float32)
    x[:8] = [0.0, -0.0, 1e-40, -1e-45, np.inf, -np.inf, np.nan, 1.0]
    p = np.array([np.float32(10.0 ** k) for k in range(-37, 38)], np.float32)
    ulps = np.abs(np.abs(x).view(np.int32)[:, None]
                  - p.view(np.int32)[None, :]).min(axis=1)
    x = x[ulps > 64]
    a = np.asarray(j_round(jnp.asarray(x), sig)).view(np.uint32)
    b = round_significant(torch.from_numpy(x), sig).numpy().view(np.uint32)
    np.testing.assert_array_equal(b, a)

    band = _decade_band(sig)
    a = np.asarray(j_round(jnp.asarray(band), sig)).view(np.uint32)
    b = round_significant(torch.from_numpy(band), sig).numpy().view(
        np.uint32)
    assert int((a != b).sum()) == {3: 6, 4: 2}[sig]


def test_make_keys_matches_reference():
    rng = np.random.default_rng(4)
    x = (10.0 ** rng.uniform(-6, 3, size=(500, 10))).astype(np.float32)
    jcfg = J.SurrogateConfig(sig_digits=3)
    tcfg = T.SurrogateConfig(sig_digits=3)
    np.testing.assert_array_equal(
        _np(T.make_keys(tcfg, torch.from_numpy(x))),
        np.asarray(J.surrogate.make_keys(jcfg, jnp.asarray(x))))
