"""The port's prefix-cache serving engine against the JAX package's
``repro.serving`` on the CPU: the three dense configs, the untied head,
prefix K/V in attention, ``chain_block_keys``, the page pool,
``prefill_collect`` and the reference's two engine scenarios
(``tests/test_substrate.py``) through both engines.

Both sides get the same weights: ``repro.models.init_lm``'s tree as numpy
arrays, loaded into the port by ``convert.lm_params_from_numpy``.
Tolerances: float32 on both sides, sums in another order, so attention
and K/V at rtol 1e-5, logits at rtol/atol 1e-4; keys, counts, stats,
tokens, slab words and generation counters bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in an xdist worker)

import repro.models as jm
from repro.configs.common import reduced as j_reduced
from repro.configs.registry import get_config as j_get_config
from repro.models import attention as jattn
from repro.models.config import ModelConfig as JConfig
from repro.serving import Engine as JEngine
from repro.serving import prefill as jprefill
from repro.serving import prefix_cache as jpc
from repro_torch import models as tm
from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_params_from_numpy, state_to_numpy
from repro_torch.models import attention as tattn
from repro_torch.models.layers import norm
from repro_torch.serving import Engine, GenerationResult, PrefixCache
from repro_torch.serving import prefill as tprefill
from repro_torch.serving import prefix_cache as tpc

CPU = "cpu"
DENSE = ("llama3-405b", "qwen1.5-32b", "starcoder2-3b")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, rtol, atol=0.0):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


def _model(arch, n_layers=None, seed=3, perturb=True):
    """(cfg, jcfg, jparams, port lm) of the reduced ``arch`` on one set of
    weights; with ``perturb`` every norm scale and bias is drawn from a
    seed (the reference initialises them to zero)."""
    cfg = reduced(get_config(arch), n_layers=n_layers)
    jcfg = JConfig(**dataclasses.asdict(cfg))
    tree = jax.tree.map(np.array, jm.init_lm(jcfg, jax.random.PRNGKey(seed)))
    if perturb:
        rng = np.random.default_rng(seed)

        def draw(path, a):
            if getattr(path[-1], "key", None) in ("scale", "bias", "b"):
                return (0.3 * rng.standard_normal(a.shape)).astype(np.float32)
            return a

        tree = jax.tree_util.tree_map_with_path(draw, tree)
    return cfg, jcfg, jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(
        cfg, tree, device=CPU)


@pytest.fixture(scope="module")
def llama():
    return _model("llama3-405b", n_layers=2)


@pytest.fixture(scope="module")
def qwen():
    return _model("qwen1.5-32b", n_layers=2)


def test_serving_exports_match_reference():
    import repro.serving
    import repro_torch.serving

    names = ("Engine", "GenerationResult", "PrefixCache", "make_serve_step")
    for name in names:
        assert hasattr(repro.serving, name)
        assert callable(getattr(repro_torch.serving, name)), name


# ---------------------------------------------------------------------------
# configs and the untied head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_dense_configs_match_reference(arch):
    full, jfull = get_config(arch), j_get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert full.param_count() == jfull.param_count()
    assert (dataclasses.asdict(reduced(full))
            == dataclasses.asdict(j_reduced(jfull)))


@pytest.mark.parametrize("fixture", ["llama", "qwen"])
def test_untied_head_loads_and_counts(fixture, request):
    cfg, _jcfg, jparams, lm = request.getfixturevalue(fixture)
    assert not cfg.tie_embeddings
    assert isinstance(lm.head, torch.nn.Parameter)
    _close(lm.head, jparams["head"]["table"], rtol=0)
    assert tm.param_count(lm) == jm.param_count(jparams) == cfg.param_count()
    lm.refresh_head()          # leaves an untied head as it is
    _close(lm.head, jparams["head"]["table"], rtol=0)


def test_untied_head_tree_mismatch_raises(llama):
    cfg, _jcfg, jparams, _lm = llama
    tree = jax.tree.map(np.array, jparams)
    del tree["head"]
    with pytest.raises(ValueError, match="tie_embeddings"):
        lm_params_from_numpy(cfg, tree, device=CPU)


# ---------------------------------------------------------------------------
# chain keys and the page pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page_size", [1, 16, 64])
def test_chain_block_keys_match_reference(page_size):
    rng = np.random.default_rng(page_size)
    for n_blocks, vocab in ((1, 512), (5, 128_256), (9, 2**31)):
        toks = rng.integers(0, vocab, size=n_blocks * page_size)
        port = tpc.chain_block_keys(toks, page_size)
        ref = jpc.chain_block_keys(toks, page_size)
        assert port.dtype == np.uint32 and port.shape == (n_blocks, tpc.KEY_WORDS)
        np.testing.assert_array_equal(port, ref)
    # a shared prefix gives the same leading keys, a changed block all later
    a = rng.integers(0, 512, size=4 * page_size)
    b = a.copy()
    b[2 * page_size] += 1
    ka, kb = tpc.chain_block_keys(a, page_size), tpc.chain_block_keys(b, page_size)
    np.testing.assert_array_equal(ka[:2], kb[:2])
    assert (ka[2:, :2] != kb[2:, :2]).any(axis=1).all()
    if page_size > 1:
        with pytest.raises(ValueError):
            tpc.chain_block_keys(a[:-1], page_size)


def test_page_pool_alloc_recycle_matches_reference():
    port = tpc.PagePool.create(5, 2, 4, 2, 8, torch.float32, device=CPU)
    ref = jpc.PagePool.create(5, 2, 4, 2, 8, jnp.float32)
    rng = np.random.default_rng(0)
    for n in (2, 3, 1, 4, 2, 5):
        ids = port.alloc(n)
        np.testing.assert_array_equal(ids, ref.alloc(n))
        np.testing.assert_array_equal(port.gen, ref.gen)
        assert list(port.fifo) == list(ref.fifo) and port.free == ref.free
        kp = rng.standard_normal((n, 2, 4, 2, 8)).astype(np.float32)
        vp = rng.standard_normal((n, 2, 4, 2, 8)).astype(np.float32)
        port.write(ids, _t(kp), _t(vp))
        ref.write(ids, jnp.asarray(kp), jnp.asarray(vp))
    for name in ("k", "v"):
        _close(getattr(port, name), getattr(ref, name), rtol=0)
    ids = np.array([4, 0, 2], np.int32)
    for p, r in zip(port.read(ids), ref.read(ids)):
        _close(p, r, rtol=0)


def test_prefix_cache_defaults_to_cuda(llama):
    cfg, *_ = llama
    if torch.cuda.is_available():
        assert PrefixCache(cfg, n_pages=4, page_size=8).pool.k.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        PrefixCache(cfg, n_pages=4, page_size=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, llama[3], max_len=64, page_size=8, pool_pages=4)


# ---------------------------------------------------------------------------
# attention over a prefix
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gemma():
    return _model("gemma3-12b")


def _layer_params(jparams, cfg, i):
    from repro_torch.models.stack import find_period

    p, n_full, _ = find_period(cfg.block_pattern)
    if i < n_full * p:
        return jax.tree.map(lambda a: a[i // p],
                            jparams["stack"]["scan"][f"b{i % p}"])["attn"]
    return jparams["stack"]["tail"][i - n_full * p]["attn"]


@pytest.mark.parametrize("layer,s,p", [
    (0, 24, 40),     # attn_local (window 16), the direct masked path
    (5, 24, 40),     # attn, the direct path
    (5, 2056, 40),   # attn above DIRECT_ATTN_MAX_SEQ: chunked, q_pos != k_pos
])
def test_prefixed_attention_matches_reference(gemma, layer, s, p):
    """Keys ``[prefix, self]``: the prefix's last 8 rows sit at position
    -1 (masked); ``collect_kv`` returns this call's post-RoPE (k, v)."""
    cfg, jcfg, jparams, lm = gemma
    kind = cfg.block_pattern[layer]
    rng = np.random.default_rng(layer + s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    pk = rng.standard_normal((2, p, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
    pv = rng.standard_normal((2, p, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
    p_pos = np.broadcast_to(np.arange(p, dtype=np.int32), (2, p)).copy()
    p_pos[:, p - 8:] = -1
    pos = np.broadcast_to(np.arange(s, dtype=np.int32) + p - 8, (2, s)).copy()
    ref, (rk, rv) = jattn.attention(
        _layer_params(jparams, cfg, layer), jcfg, kind, jnp.asarray(x),
        jnp.asarray(pos), kv_prefix=tuple(map(jnp.asarray, (pk, pv, p_pos))),
        collect_kv=True)
    port, (k, v) = lm.stack.layers[layer].attn(
        _t(x), _t(pos), kv_prefix=(_t(pk), _t(pv), _t(p_pos)), collect_kv=True)
    _close(port, ref, rtol=1e-5, atol=1e-5)
    _close(k, rk, rtol=1e-5, atol=1e-6)
    _close(v, rv, rtol=1e-5, atol=1e-6)


def test_collect_kv_without_prefix_matches_reference(gemma):
    """A local layer without a prefix keeps the kernel path and returns
    its (k, v); a block passes the pair through."""
    cfg, jcfg, jparams, lm = gemma
    s = 40
    x = np.random.default_rng(9).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    ref, (rk, _rv) = jattn.attention(_layer_params(jparams, cfg, 0), jcfg,
                                     cfg.block_pattern[0], jnp.asarray(x),
                                     jnp.asarray(pos), collect_kv=True)
    port, (k, _v) = lm.stack.layers[0].attn(_t(x), _t(pos), collect_kv=True)
    _close(port, ref, rtol=1e-5, atol=1e-5)
    _close(k, rk, rtol=1e-5, atol=1e-6)
    block = lm.stack.layers[0]
    out, (bk, _bv) = block(_t(x), _t(pos), collect_kv=True)
    assert torch.equal(out, block(_t(x), _t(pos)))
    _o, (k_in, _v) = block.attn(norm(block.ln1, _t(x)), _t(pos), collect_kv=True)
    assert torch.equal(bk, k_in)


def test_local_prefix_above_direct_raises(gemma):
    cfg, _jcfg, _jp, lm = gemma
    s = tattn.DIRECT_ATTN_MAX_SEQ + 1
    x = torch.zeros(1, s, cfg.d_model)
    pk = torch.zeros(1, 4, cfg.n_kv_heads, cfg.head_dim)
    prefix = (pk, pk, torch.arange(4, dtype=torch.int32)[None])
    pos = torch.arange(s, dtype=torch.int32)[None] + 4
    with pytest.raises(NotImplementedError, match="F11"):
        lm.stack.layers[0].attn(x, pos, kv_prefix=prefix)


# ---------------------------------------------------------------------------
# prefill_collect
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fixture", ["llama", "qwen"])
@pytest.mark.parametrize("p_len", [0, 32])
def test_prefill_collect_matches_reference(fixture, p_len, request):
    """The suffix of 24 tokens, after a prefix of 32 cached rows (K/V from
    the reference's own prefill of the prefix) or none."""
    cfg, jcfg, jparams, lm = request.getfixturevalue(fixture)
    rng = np.random.default_rng(p_len)
    toks = rng.integers(0, cfg.vocab_size, size=(2, p_len + 24)).astype(np.int32)
    jprefix = prefix = None
    if p_len:
        _lg, jk, jv = jprefill.prefill_collect(
            jparams, jcfg, {"tokens": jnp.asarray(toks[:, :p_len])})
        jpos = jnp.broadcast_to(jnp.arange(p_len, dtype=jnp.int32), (2, p_len))
        jprefix = (jk, jv, jpos)
        prefix = tuple(_t(a) for a in jprefix)
    ref = jprefill.prefill_collect(jparams, jcfg,
                                   {"tokens": jnp.asarray(toks[:, p_len:])},
                                   kv_prefix=jprefix)
    logits, ks, vs = tprefill.prefill_collect(
        lm, cfg, {"tokens": _t(toks[:, p_len:])}, kv_prefix=prefix)
    assert logits.shape == (2, cfg.padded_vocab)
    assert ks.shape == (cfg.n_layers, 2, 24, cfg.n_kv_heads, cfg.head_dim)
    _close(logits, ref[0], rtol=1e-4, atol=1e-4)
    _close(ks, ref[1], rtol=1e-5, atol=1e-5)
    _close(vs, ref[2], rtol=1e-5, atol=1e-5)
    if p_len:
        # the suffix after a cached prefix equals the whole prompt's last
        # rows and last logits
        whole = tprefill.prefill_collect(lm, cfg, {"tokens": _t(toks)})
        _close(logits, whole[0].numpy(), rtol=1e-4, atol=1e-4)
        _close(ks, whole[1][:, :, p_len:].numpy(), rtol=1e-4, atol=1e-5)
    else:
        _close(logits, tm.prefill(lm, {"tokens": _t(toks)}).numpy(), rtol=0)


def test_prefill_collect_refuses_periodic_stacks(gemma):
    cfg, jcfg, _jp, lm = gemma
    with pytest.raises(ValueError) as err:
        tprefill.prefill_collect(lm, cfg, {"tokens": torch.zeros(1, 4, dtype=torch.int64)})
    with pytest.raises(AssertionError) as jerr:
        jprefill._check(jcfg)
    assert str(err.value) == str(jerr.value)
    assert "gemma3-12b has period 6" in str(err.value)


# ---------------------------------------------------------------------------
# the engine: the reference's two scenarios through both engines
# ---------------------------------------------------------------------------

def _engines(pool_pages):
    """The reference's engine setup (reduced qwen1.5-32b, 2 layers, key
    3, float32) in both packages on the same weights."""
    cfg, jcfg, jparams, lm = _model("qwen1.5-32b", n_layers=2, perturb=False)
    kw = dict(max_len=128, page_size=32, pool_pages=pool_pages)
    return (JEngine(jcfg, jparams, dtype=jnp.float32, **kw),
            Engine(cfg, lm, dtype=torch.float32, device=CPU, **kw))


def _warm_cold():
    """test_engine_warm_equals_cold_and_counts: one prompt batch twice."""
    jeng, eng = _engines(32)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, eng.cfg.vocab_size, size=(2, 64)).astype(np.int32)
    runs = [(jeng.generate(prompts, 6), eng.generate(prompts, 6))
            for _ in range(2)]
    return jeng, eng, runs


def _eviction():
    """test_engine_pool_eviction_invalidates_stale_pointers: a 4-page pool,
    prompts p1, p2, p3 of 2 pages each, then p1 again."""
    jeng, eng = _engines(4)
    rng = np.random.default_rng(1)
    ps = [rng.integers(0, eng.cfg.vocab_size, size=(1, 64)).astype(np.int32)
          for _ in range(3)]
    runs = [(jeng.generate(p, 4), eng.generate(p, 4)) for p in ps + ps[:1]]
    return jeng, eng, runs


@pytest.fixture(scope="module")
def scenarios():
    return {"warm_cold": _warm_cold(), "eviction": _eviction()}


@pytest.mark.parametrize("name", ["warm_cold", "eviction"])
def test_engine_scenarios_match_reference(scenarios, name):
    """Tokens, prefill counts and cache stats equal run by run; after the
    last run the DHT's slab words, the pool's generation counters, FIFO
    and free list equal bit for bit and its pages at rtol 1e-5."""
    jeng, eng, runs = scenarios[name]
    for jr, r in runs:
        assert isinstance(r, GenerationResult)
        assert r.tokens.dtype == np.int32
        np.testing.assert_array_equal(r.tokens, jr.tokens)
        assert r.prefill_tokens_computed == jr.prefill_tokens_computed
        assert r.prefill_tokens_cached == jr.prefill_tokens_cached
        assert r.cache_stats == jr.cache_stats
    words = state_to_numpy(eng.prefix_cache.dht)
    for field in ("keys", "vals", "meta", "csum"):
        np.testing.assert_array_equal(
            words[field], np.asarray(getattr(jeng.prefix_cache.dht, field)))
    pool, jpool = eng.prefix_cache.pool, jeng.prefix_cache.pool
    np.testing.assert_array_equal(pool.gen, jpool.gen)
    assert list(pool.fifo) == list(jpool.fifo) and pool.free == jpool.free
    for field in ("k", "v"):
        _close(getattr(pool, field), getattr(jpool, field), rtol=1e-5, atol=1e-5)


def test_engine_scenario_gates(scenarios):
    """The reference tests' own gates, on the port: a full hit repeats the
    cold tokens with no prefill compute; an evicted prefix is recomputed
    to the same tokens; nothing is dropped in any DHT round."""
    _j, eng, runs = scenarios["warm_cold"]
    (_, r1), (_, r2) = runs
    np.testing.assert_array_equal(r1.tokens, r2.tokens)
    assert r1.prefill_tokens_cached == 0
    assert r2.prefill_tokens_cached == 128 and r2.prefill_tokens_computed == 0
    assert r2.cache_stats == {"block_hits": 4, "block_misses": 4, "stale": 0,
                              "published": 4}
    _close(r2.logits_last, r1.logits_last.numpy(), rtol=1e-4, atol=1e-4)
    _j, eng, runs = scenarios["eviction"]
    (_, a), _, _, (_, b) = runs
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert b.prefill_tokens_computed > 0
    for st in eng.prefix_cache.round_stats.values():
        assert int(st["dropped"]) == 0


def test_example_twin_runs_on_cpu():
    """``examples/torch_serve_prefix_cache.py`` at its own sizes: cold,
    shared prefix, full hit, with the reference example's counts."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "torch_serve_prefix_cache.py"
    spec = importlib.util.spec_from_file_location("torch_serve_prefix_cache", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    r1, r2, r3 = mod.run("cpu")
    assert [(r.prefill_tokens_computed, r.prefill_tokens_cached)
            for r in (r1, r2, r3)] == [(512, 0), (128, 384), (0, 512)]
    np.testing.assert_array_equal(r3.tokens, r2.tokens)
    assert r3.cache_stats == {"block_hits": 14, "block_misses": 10,
                              "stale": 0, "published": 10}
