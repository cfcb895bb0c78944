"""The port's ``data``, ``data.memo`` and ``checkpoint`` packages against the
JAX package's on the CPU, and the page pool's F12 guard.

Data arrays, memo digests and table words, and rehashed table words are
held bit for bit; a checkpoint written by either package is read by the
other, with equal ``manifest.json``; logits from restored weights at
rtol/atol 1e-4 (float32, sums in another order).
"""
import dataclasses
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in an xdist worker)

import repro.models as jm
from repro import checkpoint as jckpt
from repro.core import DHTConfig as JDHTConfig
from repro.core.layout import DHTState as JDHTState
from repro.data import memo as jmemo
from repro.data import pipeline as jpipe
from repro.models.config import ModelConfig as JConfig
from repro_torch import checkpoint as tckpt
from repro_torch import models as tm
from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_params_from_numpy, state_to_numpy
from repro_torch.core import DHTConfig, dht_create, dht_read, dht_write
from repro_torch.data import memo as tmemo
from repro_torch.data import pipeline as tpipe
from repro_torch.serving import Engine
from repro_torch.serving import prefix_cache as tpc

CPU = "cpu"


def _words(t):
    return t.cpu().numpy().view(np.uint32)


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _same_words(port_state, ref_state):
    words = state_to_numpy(port_state)
    for field in ("keys", "vals", "meta", "csum"):
        np.testing.assert_array_equal(words[field],
                                      np.asarray(getattr(ref_state, field)))


def test_exports_match_reference():
    import types

    import repro.checkpoint
    import repro.data
    import repro_torch.checkpoint
    import repro_torch.data

    for ref, port in ((repro.data, repro_torch.data),
                      (repro.checkpoint, repro_torch.checkpoint)):
        names = {n for n in dir(ref) if not n.startswith("_")
                 and not isinstance(getattr(ref, n), types.ModuleType)}
        assert names and all(callable(getattr(port, n)) for n in names), names


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step,shard,n_shards", [
    (0, 0, 1), (3, 0, 2), (3, 1, 2), (7, 3, 4)])
def test_data_batches_match_reference(step, shard, n_shards):
    kw = dict(vocab_size=512, seq_len=16, global_batch=8, seed=5)
    port = tpipe.get_batch(tpipe.DataConfig(**kw), step,
                           tpipe.ShardInfo(shard, n_shards))
    ref = jpipe.get_batch(jpipe.DataConfig(**kw), step,
                          jpipe.ShardInfo(shard, n_shards))
    assert set(port) == set(ref) == {"tokens", "labels"}
    for name in port:
        assert port[name].dtype == np.int32 and port[name].shape == (8 // n_shards, 16)
        np.testing.assert_array_equal(port[name], ref[name])
    np.testing.assert_array_equal(
        tpipe.batch_doc_ids(tpipe.DataConfig(**kw), step, tpipe.ShardInfo(shard, n_shards)),
        jpipe.batch_doc_ids(jpipe.DataConfig(**kw), step, jpipe.ShardInfo(shard, n_shards)))


@pytest.mark.parametrize("dead", [0, 2, 3])
def test_reassign_straggler_matches_reference(dead):
    kw = dict(vocab_size=512, seq_len=16, global_batch=12)
    covered = []
    for s in range(4):
        if s == dead:
            continue
        port = tpipe.reassign_straggler(tpipe.DataConfig(**kw), 7, dead,
                                        tpipe.ShardInfo(s, 4))
        ref = jpipe.reassign_straggler(jpipe.DataConfig(**kw), 7, dead,
                                       jpipe.ShardInfo(s, 4))
        np.testing.assert_array_equal(port, ref)
        covered.extend(port.tolist())
    expect = tpipe.batch_doc_ids(tpipe.DataConfig(**kw), 7, tpipe.ShardInfo(dead, 4))
    assert sorted(covered) == expect.tolist()
    with pytest.raises(ValueError):
        tpipe.ShardInfo(4, 4)


# ---------------------------------------------------------------------------
# memo
# ---------------------------------------------------------------------------

def test_expensive_transform_matches_reference():
    """uint32 wrap of the product and the sum, a logical right shift: ids
    across the int32 range, negative ones included."""
    ids = np.array([0, 1, 7, 2**31 - 1, -1, -2**31, 123456789, -987654321],
                   np.int32)
    port = tmemo._expensive_transform(torch.from_numpy(ids))
    ref = jmemo._expensive_transform(jnp.asarray(ids))
    assert port.dtype == torch.int32 and port.shape == (8, 16)
    np.testing.assert_array_equal(_words(port), np.asarray(ref))
    np.testing.assert_array_equal(_words(tmemo._keys_of(torch.from_numpy(ids))),
                                  np.asarray(jmemo._keys_of(jnp.asarray(ids))))


def test_memo_lookup_or_process_matches_reference():
    """Two epochs over 100 docs (no hit, then all), then 100 docs half of
    them seen: digests, hits and table words equal after every call."""
    state = tmemo.create(tmemo.memo_config(n_shards=2, buckets_per_shard=1 << 10),
                         device=CPU)
    jstate = jmemo.create(jmemo.memo_config(n_shards=2, buckets_per_shard=1 << 10))
    hits = []
    for ids in (np.arange(100), np.arange(100), np.arange(50, 150)):
        ids = ids.astype(np.int32)
        state, dig, h = tmemo.lookup_or_process(state, torch.from_numpy(ids))
        jstate, jdig, jh = jmemo.lookup_or_process(jstate, jnp.asarray(ids))
        assert dig.shape == (100, 16)
        np.testing.assert_array_equal(_words(dig), np.asarray(jdig))
        assert int(h) == int(jh)
        hits.append(int(h))
        _same_words(state, jstate)
    assert hits == [0, 100, 50]


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def _mixed_trees():
    """tests/test_substrate.py's mixed float32 / bfloat16 / int32 tree in
    both packages."""
    jtree = {"a": jnp.arange(10, dtype=jnp.float32),
             "b": {"c": jnp.ones((3, 4), jnp.bfloat16) * 1.5,
                   "d": [jnp.int32(7), jnp.zeros(2)]}}
    ttree = {"b": {"d": [torch.tensor(7, dtype=torch.int32), torch.zeros(2)],
                   "c": torch.full((3, 4), 1.5, dtype=torch.bfloat16)},
             "a": torch.arange(10, dtype=torch.float32)}
    return jtree, ttree


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_cross_package(writer):
    """One package saves steps 5 and 10, the other restores both; the two
    packages' manifests of the same tree are equal, file for file."""
    jtree, ttree = _mixed_trees()
    with tempfile.TemporaryDirectory() as d:
        dj, dt = os.path.join(d, "ref"), os.path.join(d, "port")
        for step in (5, 10):
            jckpt.save(dj, step, jtree)
            tckpt.save(dt, step, ttree)
        for step in (5, 10):
            with open(os.path.join(dj, f"step_{step}", "manifest.json")) as f:
                text = f.read()
            with open(os.path.join(dt, f"step_{step}", "manifest.json")) as f:
                assert f.read() == text
            assert json.loads(text)["leaves"]["b/c"]["dtype"] == "bfloat16"
        assert sorted(os.listdir(dt)) == sorted(os.listdir(dj)) == [
            "LATEST", "step_10", "step_5"]
        src = dj if writer == "reference" else dt
        assert tckpt.latest_step(src) == jckpt.latest_step(src) == 10
        step, back = tckpt.restore(src, ttree, device=CPU)
        assert step == 10
        assert back["b"]["c"].dtype == torch.bfloat16
        assert back["b"]["d"][0].dtype == torch.int32
        for x, y in zip(jax.tree.leaves(jtree), jax.tree.leaves(
                jax.tree.map(lambda t: t.float().numpy(), back))):
            np.testing.assert_array_equal(np.asarray(x, np.float32), y)
        jstep, jback = jckpt.restore(src, jtree, step=5)
        assert jstep == 5
        assert jback["b"]["c"].dtype == jnp.bfloat16
        for x, y in zip(jax.tree.leaves(jtree), jax.tree.leaves(jback)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    with pytest.raises(FileNotFoundError):
        tckpt.restore(d, ttree, device=CPU)


def test_checkpoint_of_reference_lm_feeds_the_port():
    """The reference saves ``init_lm`` of reduced qwen1.5-32b; the port
    restores the tree and ``lm_params_from_numpy`` takes it as it comes:
    logits equal the reference's.  A bfloat16 copy restores to bfloat16
    tensors that load as the same numbers as its numpy form."""
    cfg = reduced(get_config("qwen1.5-32b"), n_layers=2)
    jcfg = JConfig(**dataclasses.asdict(cfg))
    jparams = jm.init_lm(jcfg, jax.random.PRNGKey(4))
    target = jax.tree.map(np.array, jparams)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(2, 12))
    with tempfile.TemporaryDirectory() as d:
        jckpt.save(d, 3, jparams)
        step, tree = tckpt.restore(d, target, device=CPU)
        assert step == 3
        lm = lm_params_from_numpy(cfg, tree, device=CPU)
        ref, _ = jm.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)}, remat=False)
        port = tm.forward(lm, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
        half = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
        jckpt.save(d, 4, half)
        _step, tree16 = tckpt.restore(d, target, device=CPU)
    assert tree16["embed"]["table"].dtype == torch.bfloat16
    a = lm_params_from_numpy(cfg, tree16, device=CPU)
    b = lm_params_from_numpy(cfg, jax.tree.map(
        lambda x: np.asarray(x).astype(np.float32), half), device=CPU)
    for (name, pa), (_n, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
    assert np.asarray(half["embed"]["table"]).dtype == ml_dtypes.bfloat16


# ---------------------------------------------------------------------------
# rehash_dht
# ---------------------------------------------------------------------------

def _rehash_source(cfg_kw, n_keys, seed):
    """A table written by the port, and the reference's state on the
    same words."""
    cfg = DHTConfig(**cfg_kw)
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, size=(n_keys, cfg.key_words), dtype=np.uint32)
    vals = rng.integers(0, 2**32, size=(n_keys, cfg.val_words), dtype=np.uint32)
    st = dht_create(cfg, device=CPU)
    for i in range(0, n_keys, 4096):
        st, _ = dht_write(st, _i32(keys[i:i + 4096]), _i32(vals[i:i + 4096]))
    w = state_to_numpy(st)
    jst = JDHTState(cfg=JDHTConfig(**cfg_kw), **{f: jnp.asarray(w[f]) for f in w})
    return st, jst, keys, vals


@pytest.mark.parametrize("cfg_kw,n_keys,new_shards,new_buckets", [
    (dict(n_shards=4, buckets_per_shard=1024), 200, 8, 1024),
    (dict(n_shards=4, buckets_per_shard=1024), 200, 2, 1024),
    # 9,000 live rows: a round of 8,192 and one of the rest
    (dict(key_words=4, val_words=4, n_shards=4, buckets_per_shard=8192),
     9000, 2, 16384),
])
def test_rehash_dht_matches_reference(cfg_kw, n_keys, new_shards, new_buckets):
    """The reference's 200-row grow and shrink, and a table whose live
    rows cross the re-insert batch: the same words, the same keys read
    back with their values."""
    st, jst, keys, vals = _rehash_source(cfg_kw, n_keys, seed=n_keys + new_shards)
    st, _o, stored, _ = dht_read(st, _i32(keys))
    stored = stored.numpy()
    live = int(((st.meta & 1) != 0).sum())
    assert live == stored.sum() and live > 0.99 * n_keys
    assert (live > tckpt.checkpoint.REHASH_BATCH) == (n_keys > 8192)
    new_kw = dict(cfg_kw, n_shards=new_shards, buckets_per_shard=new_buckets)
    port = tckpt.rehash_dht(st, DHTConfig(**new_kw))
    ref = jckpt.rehash_dht(jst, JDHTConfig(**new_kw))
    _same_words(port, ref)
    # equal words read back alike: the port's read is held against the
    # reference's in tests/test_torch_engine.py
    port, out, found, _ = dht_read(port, _i32(keys))
    found = found.numpy()
    np.testing.assert_array_equal(_words(out)[found], vals[found])
    # a re-insert round evicts where a window fills: what is not read
    # back is what the live count lost (none at the reference's 200 rows)
    assert not (found & ~stored).any()
    assert found.sum() == int(((port.meta & 1) != 0).sum())
    assert (found == stored).all() == (n_keys == 200)


def test_rehash_dht_empty_and_width_change():
    cfg = DHTConfig(n_shards=2, buckets_per_shard=64)
    fresh = tckpt.rehash_dht(dht_create(cfg, device=CPU),
                             dataclasses.replace(cfg, n_shards=4))
    assert fresh.cfg.n_shards == 4 and not bool(fresh.flat_meta.any())
    with pytest.raises(ValueError, match="row widths"):
        tckpt.rehash_dht(dht_create(cfg, device=CPU),
                         dataclasses.replace(cfg, key_words=4))
    # an INVALID row is not live: it is not carried over
    st, _ = dht_write(dht_create(cfg, device=CPU), _i32(np.arange(40).reshape(2, 20)),
                      _i32(np.arange(52).reshape(2, 26)))
    st.meta[st.meta != 0] |= 2
    assert not bool(tckpt.rehash_dht(st, cfg).flat_meta.any())
    jst = JDHTState(cfg=JDHTConfig(n_shards=2, buckets_per_shard=64),
                    **{f: jnp.asarray(w) for f, w in state_to_numpy(st).items()})
    assert not np.asarray(jckpt.rehash_dht(jst, JDHTConfig(
        n_shards=2, buckets_per_shard=64)).meta).any()


# ---------------------------------------------------------------------------
# F12: one publish of more pages than the pool holds
# ---------------------------------------------------------------------------

def test_publish_beyond_the_pool_raises_f12():
    """n_pages=2, page_size=4 and one prompt of 3 blocks: the reference
    hands out pages [1, 0, 1] and serves block 2's rows for block 0; the
    port raises before it allocates, in ``publish`` and, before any
    prefill, in ``Engine.generate``."""
    cfg = reduced(get_config("qwen1.5-32b"), n_layers=2)
    pc = tpc.PrefixCache(cfg, n_pages=2, page_size=4, dtype=torch.float32,
                         device=CPU)
    prompt = np.arange(12, dtype=np.int32)[None]
    ks = torch.zeros(cfg.n_layers, 1, 12, cfg.n_kv_heads, cfg.head_dim)
    with pytest.raises(ValueError, match="F12"):
        pc.publish(prompt, 0, ks, ks)
    assert list(pc.pool.fifo) == [] and pc.stats["published"] == 0
    pc.publish(prompt[:, :8], 0, ks[:, :, :8], ks[:, :, :8])   # 2 pages fit
    assert sorted(pc.pool.fifo) == [0, 1]

    lm = tm.init_lm(cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    eng = Engine(cfg, lm, max_len=32, page_size=4, pool_pages=2,
                 dtype=torch.float32, device=CPU)
    calls = []
    eng.lm.stack.layers[0].register_forward_hook(lambda *a: calls.append(1))
    with pytest.raises(ValueError, match="F12"):
        eng.generate(prompt, 2)
    assert calls == [] and list(eng.prefix_cache.pool.fifo) == []
