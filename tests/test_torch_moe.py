"""The port's MoE layer and blocks against the JAX package's
``repro.models.moe`` on the CPU: reduced qwen3-moe-235b-a22b (top-8 of
128 cut to top-2 of 4, QK-norm) and llama4-scout-17b-a16e (top-1 and a
shared expert), float32, the same weights on both sides
(``convert.lm_params_from_numpy``).

Tolerances: float32, sums in another order: the layer's output at 1e-5,
its aux loss at 1e-6 and its drop count exact; logits at rtol/atol 1e-4;
decode against forward within the reference's 2e-2
(``tests/test_models.py``); the engine's tokens, counts and stats bit
for bit.
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
from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JConfig
from repro.serving import Engine as JEngine
from repro.serving import prefill as jprefill
from repro_torch import models as tm
from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import moe as tmoe
from repro_torch.serving import Engine
from repro_torch.serving import prefill as tprefill

CPU = "cpu"
MOE = ("qwen3-moe-235b-a22b", "llama4-scout-17b-a16e")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, rtol, atol=0.0):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


def _model(arch, seed=3):
    """(cfg, jcfg, jparams, port lm) of the reduced ``arch`` (2 layers) on
    one set of weights, its norm scales drawn from a seed (the reference
    initialises them to zero)."""
    cfg = reduced(get_config(arch))
    jcfg = JConfig(**dataclasses.asdict(cfg))
    tree = jax.tree.map(np.array, jm.init_lm(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def draw(path, a):
        if getattr(path[-1], "key", None) == "scale":
            return (0.3 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    tree = jax.tree_util.tree_map_with_path(draw, tree)
    return cfg, jcfg, jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(
        cfg, tree, device=CPU)


@pytest.fixture(scope="module")
def models():
    return {arch: _model(arch) for arch in MOE}


def _moe_params(tree):
    """The reference's ``moe`` tree as the dict ``moe_forward`` takes:
    ``{"router": {"w"}, ...}`` with the shared MLP as ``{name: W}``."""
    out = {n: {"w": _t(tree[n]["w"])} for n in ("router", "wi", "wg", "wo")}
    if "shared" in tree:
        out["shared"] = {n: _t(w["w"]) for n, w in tree["shared"].items()}
    return out


@pytest.mark.parametrize("arch", MOE)
def test_moe_configs_match_reference(arch):
    full, jfull = get_config(arch), j_get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert full.param_count() == jfull.param_count()
    assert (dataclasses.asdict(reduced(full))
            == dataclasses.asdict(j_reduced(jfull)))


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,n_groups,capacity,ties,drops", [
    ("qwen3-moe-235b-a22b", 32, 1.25, False, False),
    ("llama4-scout-17b-a16e", 32, 1.25, False, False),
    ("qwen3-moe-235b-a22b", 1, 0.25, False, True),    # capacity 8 of 32 a bin
    ("llama4-scout-17b-a16e", 2, 0.25, False, True),
    ("qwen3-moe-235b-a22b", 4, 1.25, True, True),     # a zero router: all tie
])
def test_moe_forward_matches_reference(arch, n_groups, capacity, ties, drops):
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              expert_capacity_factor=capacity)
    jcfg = JConfig(**dataclasses.asdict(cfg))
    tree = jax.tree.map(np.array, jmoe.init_moe(jax.random.PRNGKey(1), jcfg))
    if ties:
        tree["router"]["w"][:] = 0.0
    x = np.random.default_rng(2).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    ref, rstats = jmoe.moe_forward(jax.tree.map(jnp.asarray, tree), jcfg,
                                   jnp.asarray(x), n_groups=n_groups)
    y, stats = tmoe.moe_forward(_moe_params(tree), cfg, _t(x), n_groups=n_groups)
    assert y.shape == x.shape and y.dtype == torch.float32
    _close(y, ref, rtol=1e-5, atol=1e-5)
    _close(stats["aux_loss"], rstats["aux_loss"], rtol=1e-6, atol=1e-6)
    assert int(stats["dropped"]) == int(rstats["dropped"])
    assert (int(stats["dropped"]) > 0) == drops


def test_init_moe_layout_and_module_form():
    """``init_moe`` builds the reference's layout (router float32, experts
    in the working type); the module and the dict give the same output."""
    cfg = reduced(get_config("llama4-scout-17b-a16e"))
    mod = tmoe.init_moe(cfg, torch.Generator().manual_seed(0), CPU)
    jtree = jmoe.init_moe(jax.random.PRNGKey(0), JConfig(**dataclasses.asdict(cfg)))
    assert set(mod.keys()) == set(jtree)
    for name in ("router", "wi", "wg", "wo"):
        assert tuple(mod[name]["w"].shape) == jtree[name]["w"].shape
    assert set(mod["shared"].keys()) == set(jtree["shared"])
    x = torch.randn(1, 8, cfg.d_model, generator=torch.Generator().manual_seed(1))
    as_dict = {n: ({"w": mod[n]["w"]} if n != "shared" else dict(mod[n]))
               for n in mod.keys()}
    a, sa = tmoe.moe_forward(mod, cfg, x)
    b, sb = tmoe.moe_forward(as_dict, cfg, x)
    assert torch.equal(a, b) and torch.equal(sa["aux_loss"], sb["aux_loss"])


# ---------------------------------------------------------------------------
# blocks, logits, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_moe_lm_logits_match_reference(models, arch):
    """The MoE blocks through the whole reduced model: logits equal to the
    reference's ``forward`` on the same weights, the parameter counts
    equal, and each block keeps its last stats (nothing dropped at 24
    tokens: groups of one token, capacity 8)."""
    cfg, jcfg, jparams, lm = models[arch]
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(2, 24))
    ref, _aux = jm.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)}, remat=False)
    port = tm.forward(lm, {"tokens": _t(toks)})
    _close(port, ref, rtol=1e-4, atol=1e-4)
    # the tree's count (the config's analytic count leaves out QK-norm)
    assert tm.param_count(lm) == jm.param_count(jparams)
    for block in lm.stack.layers:
        assert block.kind == "moe"
        assert set(block.moe_stats) == {"aux_loss", "dropped"}
        assert int(block.moe_stats["dropped"]) == 0


@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_matches_forward(models, arch):
    """The reference's decode test on the port: 12 greedy-position decode
    steps against one forward, within 2e-2; and each step's logits
    against the reference's decode step."""
    cfg, jcfg, jparams, lm = models[arch]
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, size=(2, 12))
    full = tm.forward(lm, {"tokens": _t(toks)})
    cache = tm.init_cache(cfg, 2, 32, torch.float32, device=CPU)
    jcache = jm.init_cache(jcfg, 2, 32, jnp.float32)
    errs = []
    for t in range(12):
        lg, cache = tm.decode_step(lm, cache, _t(toks[:, t:t + 1]), t)
        jlg, jcache = jm.decode_step(jparams, jcfg, jcache,
                                     jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        errs.append(float((lg - full[:, t]).abs().max()))
        _close(lg, jlg, rtol=1e-4, atol=1e-4)
    assert max(errs) < 2e-2, f"{arch}: decode diverges from forward ({max(errs)})"


# ---------------------------------------------------------------------------
# serving: prefill_collect and the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_moe_prefill_collect_matches_reference(models, arch):
    """``_check`` takes MoE stacks; with and without a cached prefix the
    logits and the suffix's K/V equal the reference's."""
    cfg, jcfg, jparams, lm = models[arch]
    assert tprefill._check(cfg) == jprefill._check(jcfg) == "moe"
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, size=(2, 32))
    _lg, pk, pv = tprefill.prefill_collect(lm, cfg, {"tokens": _t(toks[:, :16])})
    p_pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()
    ref = jprefill.prefill_collect(
        jparams, jcfg, {"tokens": jnp.asarray(toks[:, 16:])},
        kv_prefix=(jnp.asarray(pk.numpy()), jnp.asarray(pv.numpy()),
                   jnp.asarray(p_pos)))
    logits, ks, vs = tprefill.prefill_collect(
        lm, cfg, {"tokens": _t(toks[:, 16:])}, kv_prefix=(pk, pv, _t(p_pos)))
    _close(logits, ref[0], rtol=1e-4, atol=1e-4)
    _close(ks, ref[1], rtol=1e-5, atol=1e-5)
    _close(vs, ref[2], rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def engines(models):
    """The reference's warm/cold scenario on reduced qwen3-moe: one batch
    of 2 x 64 tokens twice through both engines on the same weights."""
    cfg, jcfg, jparams, lm = models["qwen3-moe-235b-a22b"]
    kw = dict(max_len=128, page_size=32, pool_pages=32)
    jeng = JEngine(jcfg, jparams, dtype=jnp.float32, **kw)
    eng = Engine(cfg, lm, dtype=torch.float32, device=CPU, **kw)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 64)).astype(np.int32)
    return [(jeng.generate(prompts, 6), eng.generate(prompts, 6))
            for _ in range(2)]


def test_moe_engine_warm_equals_cold_against_reference(engines):
    for jr, r in engines:
        np.testing.assert_array_equal(r.tokens, jr.tokens)
        assert r.prefill_tokens_computed == jr.prefill_tokens_computed
        assert r.prefill_tokens_cached == jr.prefill_tokens_cached
        assert r.cache_stats == jr.cache_stats
    (_, r1), (_, r2) = engines
    np.testing.assert_array_equal(r1.tokens, r2.tokens)
    assert r1.prefill_tokens_cached == 0
    assert r2.prefill_tokens_cached == 128 and r2.prefill_tokens_computed == 0
    assert r2.cache_stats == {"block_hits": 4, "block_misses": 4, "stale": 0,
                              "published": 4}
