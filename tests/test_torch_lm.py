"""The port's LM stack (gemma3-style global and sliding-window attention
blocks) against the JAX package's ``repro.models`` on the CPU.

Both sides get the same weights: ``repro.models.init_lm``'s tree, as numpy
arrays with every norm scale perturbed (the reference initialises them to
zero, which would hide the ``(1 + scale)`` form), loaded into the port by
``convert.lm_params_from_numpy``.  Inputs come from numpy seeds.
Tolerances: float32 on both sides, sums in another order, so layer
functions at rtol 1e-5 and whole-model logits at rtol/atol 1e-4.
"""
import dataclasses
import math

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
from repro.models import flash as jflash
from repro.models import layers as jl
from repro.models.config import ModelConfig as JConfig
from repro.serving.serve_step import make_serve_step as j_make_serve_step
from repro_torch import models as tm
from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import flash as tflash
from repro_torch.models import layers as tl
from repro_torch.serving import make_serve_step

CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, rtol, atol=0.0):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def setup():
    """The reduced gemma3-12b config on both sides and one set of weights."""
    cfg = reduced(get_config("gemma3-12b"))
    jcfg = JConfig(**dataclasses.asdict(cfg))
    tree = jax.tree.map(np.array, jm.init_lm(jcfg, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(0)

    def perturb(path, a):
        if getattr(path[-1], "key", None) == "scale":
            return (0.3 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    jparams = jax.tree.map(jnp.asarray, tree)
    lm = lm_params_from_numpy(cfg, tree, device=CPU)
    return cfg, jcfg, tree, jparams, lm


def test_reduced_config_matches_reference():
    cfg = reduced(get_config("gemma3-12b"))
    jcfg = j_reduced(j_get_config("gemma3-12b"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    full = get_config("gemma3-12b")
    assert dataclasses.asdict(full) == dataclasses.asdict(j_get_config("gemma3-12b"))
    assert full.param_count() == j_get_config("gemma3-12b").param_count()


def test_param_count_matches_reference(setup):
    cfg, jcfg, tree, jparams, lm = setup
    assert tm.param_count(lm) == jm.param_count(jparams)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _layer_case(name, rng):
    """(port output, reference output) of one layers function on seeded
    inputs."""
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    scale = (0.3 * rng.standard_normal(24)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(24)).astype(np.float32)
    if name in ("rmsnorm", "layernorm"):
        p = {"scale": scale, "bias": bias} if name == "layernorm" else {"scale": scale}
        return (tl.norm({k: _t(v) for k, v in p.items()}, _t(x), name),
                jl.norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), name))
    if name == "rope":
        xr = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
        pos = rng.integers(0, 5000, size=(2, 7)).astype(np.int32)
        return (tl.apply_rope(_t(xr), _t(pos), 10_000.0),
                jl.apply_rope(jnp.asarray(xr), jnp.asarray(pos), 10_000.0))
    if name in ("swiglu", "geglu", "gelu"):
        w = {n: (rng.standard_normal(s) / 5).astype(np.float32)
             for n, s in (("wi", (24, 40)), ("wg", (24, 40)), ("wo", (40, 24)))}
        if name == "gelu":
            del w["wg"]
        return (tl.mlp({n: _t(a) for n, a in w.items()}, _t(x), name),
                jl.mlp({n: {"w": jnp.asarray(a)} for n, a in w.items()},
                       jnp.asarray(x), name))
    table = rng.standard_normal((50, 24)).astype(np.float32)
    if name in ("embed", "embed_scaled"):
        ids = rng.integers(0, 50, size=(3, 6))
        scaled = name == "embed_scaled"
        return (tl.embed(_t(table), _t(ids), scale=scaled),
                jl.embed({"table": jnp.asarray(table)}, jnp.asarray(ids), scale=scaled))
    if name == "unembed":
        return (tl.unembed(_t(table), _t(x)),
                jl.unembed({"table": jnp.asarray(table)}, jnp.asarray(x)))
    w = rng.standard_normal((24, 3, 8)).astype(np.float32)
    b = rng.standard_normal((3, 8)).astype(np.float32)
    return (tl.dense(_t(w), _t(x), _t(b)),
            jl.dense({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
                     bias_key="b"))


@pytest.mark.parametrize("name", ["rmsnorm", "layernorm", "rope", "swiglu", "geglu",
                                  "gelu", "embed", "embed_scaled", "unembed",
                                  "dense"])
def test_layers_match_reference(name):
    port, ref = _layer_case(name, np.random.default_rng(len(name)))
    _close(port, ref, rtol=1e-5, atol=1e-6)


def test_rope_frequencies_match_reference():
    for theta in (10_000.0, 1_000_000.0):
        _close(tl.rope_frequencies(256, theta), jl.rope_frequencies(256, theta),
               rtol=1e-6)


@pytest.mark.parametrize("s,window,q_chunk,kv_chunk,hk", [
    (40, None, 8, 16, 2),    # unbanded, ragged keys
    (37, 5, 8, 8, 2),        # banded, ragged queries
    (48, 16, 16, 8, 1),      # banded, multi-query
    (24, 100, 8, 8, 4),      # window longer than the keys: unbanded
])
def test_chunked_attention_matches_reference(s, window, q_chunk, kv_chunk, hk):
    rng = np.random.default_rng(s + hk)
    q = rng.standard_normal((2, s, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, s, hk, 16)).astype(np.float32)
    v = rng.standard_normal((2, s, hk, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    kw = dict(causal=True, window=window, q_chunk=q_chunk, kv_chunk=kv_chunk)
    port = tflash.chunked_attention(_t(q), _t(k), _t(v), _t(pos), _t(pos), **kw)
    ref = jflash.chunked_attention(*map(jnp.asarray, (q, k, v, pos, pos)), **kw)
    _close(port, ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# attention and decode
# ---------------------------------------------------------------------------

def _layer_tree(tree, cfg, i):
    from repro_torch.models.stack import find_period

    p, n_full, _ = find_period(cfg.block_pattern)
    if i < n_full * p:
        return jax.tree.map(lambda a: a[i // p], tree["stack"]["scan"][f"b{i % p}"])
    return tree["stack"]["tail"][i - n_full * p]


@pytest.mark.parametrize("layer", [0, 5])   # attn_local, attn
def test_attention_matches_reference(setup, layer):
    cfg, jcfg, tree, _jp, lm = setup
    kind = cfg.block_pattern[layer]
    s = 48
    x = np.random.default_rng(layer).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    params = jax.tree.map(jnp.asarray, _layer_tree(tree, cfg, layer)["attn"])
    ref = jattn.attention(params, jcfg, kind, jnp.asarray(x), jnp.asarray(pos))
    port = lm.stack.layers[layer].attn(_t(x), _t(pos))
    _close(port, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("softcap,causal,s", [
    (30.0, True, 48),                                   # masked
    (30.0, True, tattn.DIRECT_ATTN_MAX_SEQ + 8),        # chunked, banded
    (None, False, 48),                                  # not causal
])
def test_local_softcap_or_bidirectional_matches_reference(setup, softcap,
                                                          causal, s):
    """A local layer with a logit softcap, or not causal, goes the
    reference's way (masked up to DIRECT_ATTN_MAX_SEQ queries, banded
    chunks above) instead of the kernel; held against
    ``repro.models.attention`` on the same weights (rtol/atol 1e-5)."""
    cfg, _jcfg, tree, _jp, _lm = setup
    cfg = dataclasses.replace(cfg, logit_softcap=softcap, causal=causal)
    jcfg = JConfig(**dataclasses.asdict(cfg))
    lm = lm_params_from_numpy(cfg, tree, device=CPU)
    x = np.random.default_rng(s).standard_normal((1, s, cfg.d_model)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)[None]
    params = jax.tree.map(jnp.asarray, _layer_tree(tree, cfg, 0)["attn"])
    ref = jattn.attention(params, jcfg, cfg.block_pattern[0], jnp.asarray(x),
                          jnp.asarray(pos))
    port = lm.stack.layers[0].attn(_t(x), _t(pos))
    _close(port, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layer", [0, 5])
def test_decode_attention_matches_reference(setup, layer):
    """24 steps past the local window: outputs and the ring buffer."""
    cfg, jcfg, tree, _jp, lm = setup
    kind = cfg.block_pattern[layer]
    steps = cfg.local_window + 24
    xs = np.random.default_rng(layer).standard_normal(
        (steps, 2, 1, cfg.d_model)).astype(np.float32)
    params = jax.tree.map(jnp.asarray, _layer_tree(tree, cfg, layer)["attn"])
    jcache = jattn.init_kv_cache(jcfg, kind, 2, 64, jnp.float32)
    cache = tattn.init_kv_cache(cfg, kind, 2, 64, torch.float32, device=CPU)
    attn = lm.stack.layers[layer].attn
    for t in range(steps):
        ref, jcache = jattn.decode_attention(params, jcfg, kind, jcache,
                                             jnp.asarray(xs[t]), jnp.int32(t))
        port = attn.decode(cache, _t(xs[t]), t)
        _close(port, ref, rtol=1e-5, atol=1e-5)
    for name in ("k", "v"):
        _close(cache[name], jcache[name], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(cache["slot_pos"].numpy(), np.asarray(jcache["slot_pos"]))


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def _tokens(cfg, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(2, s)).astype(np.int32)


def test_forward_and_prefill_match_reference(setup):
    cfg, jcfg, _tree, jparams, lm = setup
    toks = _tokens(cfg, 40)
    ref, _aux = jm.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)}, remat=False)
    port = tm.forward(lm, {"tokens": _t(toks)})
    assert port.shape == (2, 40, cfg.padded_vocab)
    _close(port, ref, rtol=1e-4, atol=1e-4)
    _close(tm.prefill(lm, {"tokens": _t(toks)}), np.asarray(ref)[:, -1],
           rtol=1e-4, atol=1e-4)


def test_decode_step_matches_reference_and_forward(setup):
    """24 decode steps (past the window of 16): logits equal the
    reference's decode and, within the reference's own 2e-2 bound, the
    port's forward at every position."""
    cfg, jcfg, _tree, jparams, lm = setup
    steps = 24
    toks = _tokens(cfg, steps, seed=2)
    full = tm.forward(lm, {"tokens": _t(toks)})
    jcache = jm.init_cache(jcfg, 2, 32, jnp.float32)
    cache = tm.init_cache(cfg, 2, 32, torch.float32, device=CPU)
    for t in range(steps):
        ref, jcache = jm.decode_step(jparams, jcfg, jcache,
                                     jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        port, cache = tm.decode_step(lm, cache, _t(toks[:, t:t + 1]), t)
        _close(port, ref, rtol=1e-4, atol=1e-4)
        assert float((port - full[:, t]).abs().max()) < 2e-2


def test_serve_step_greedy_tokens_match_reference(setup):
    """8 teacher-forced prompt steps, then 12 greedy steps fed back."""
    cfg, jcfg, _tree, jparams, lm = setup
    prompt = _tokens(cfg, 8, seed=4)
    jstep, step = j_make_serve_step(jcfg), make_serve_step(cfg)
    jcache = jm.init_cache(jcfg, 2, 32, jnp.float32)
    cache = tm.init_cache(cfg, 2, 32, torch.float32, device=CPU)
    jtok, tok = jnp.asarray(prompt[:, :1]), _t(prompt[:, :1])
    for t in range(20):
        jnext, jcache = jstep(jparams, jcache, jtok, jnp.int32(t))
        nxt, cache = step(lm, cache, tok, t)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnext))
        if t + 1 < prompt.shape[1]:
            jtok, tok = jnp.asarray(prompt[:, t + 1:t + 2]), _t(prompt[:, t + 1:t + 2])
        else:
            jtok, tok = jnext[:, None], nxt[:, None]


def test_greedy_sample_masks_padded_vocab():
    cfg = dataclasses.replace(reduced(get_config("gemma3-12b")), vocab_size=500)
    logits = torch.zeros(3, cfg.padded_vocab)
    logits[:, 505] = 9.0
    logits[:, 7] = 1.0
    ref = jm.greedy_sample(jnp.asarray(logits.numpy()), JConfig(**dataclasses.asdict(cfg)))
    out = tm.greedy_sample(logits, cfg)
    assert out.dtype == torch.int32 and out.tolist() == [7, 7, 7]
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# what is refused raises
# ---------------------------------------------------------------------------

def test_unknown_block_kind_raises():
    """A kind the reference does not know raises ``ValueError(kind)``, as
    its ``init_block`` and ``init_block_cache`` do."""
    cfg = reduced(get_config("gemma3-12b"))
    with pytest.raises(ValueError, match="conv_mixer"):
        tblocks.Block(cfg, "conv_mixer", torch.Generator().manual_seed(0), CPU)
    with pytest.raises(ValueError, match="conv_mixer"):
        tblocks.init_block_cache(cfg, "conv_mixer", 1, 8, device=CPU)


def test_unported_architectures_and_prefix_kv_raise(setup):
    """An unknown architecture raises, and so does a local layer given a
    KV prefix above DIRECT_ATTN_MAX_SEQ queries (F11: the reference's
    banded branch misses prefix keys there)."""
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    cfg, _jcfg, _tree, _jp, lm = setup
    s = tattn.DIRECT_ATTN_MAX_SEQ + 1
    x = torch.zeros(1, s, cfg.d_model)
    pos = torch.arange(s, dtype=torch.int32)[None] + 4
    pk = torch.zeros(1, 4, cfg.n_kv_heads, cfg.head_dim)
    prefix = (pk, pk, torch.arange(4, dtype=torch.int32)[None])
    with pytest.raises(NotImplementedError, match="F11"):
        lm.stack.layers[0].attn(x, pos, kv_prefix=prefix, collect_kv=True)


def test_emb_scale_and_rope_theta_follow_config(setup):
    """The embedding is scaled by sqrt(d_model) in float32 before the cast,
    and local layers rotate with rope_theta_local."""
    cfg, *_ = setup
    lm = tm.init_lm(cfg, generator=torch.Generator().manual_seed(1), device=CPU)
    toks = torch.tensor([[3, 5]])
    x = tm.model._embed_inputs(lm, {"tokens": toks})
    _close(x, lm.embed.detach()[toks] * math.sqrt(cfg.d_model), rtol=1e-6)
    big = dataclasses.replace(get_config("gemma3-12b"))
    assert tattn._theta(big, "attn_local") == 10_000.0
    assert tattn._theta(big, "attn") == 1_000_000.0
