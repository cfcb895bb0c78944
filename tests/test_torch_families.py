"""The port's remaining model families against the JAX package on the CPU:
Mamba-2 SSD blocks (mamba2-370m), RG-LRU blocks with local attention
(recurrentgemma-2b) and the modality-frontend stubs (internvl2-26b's
patch prefix, hubert-xlarge's encoder-only frames); and the serving
launcher twin.

Both sides get the same weights: ``repro.models.init_lm``'s tree as numpy
arrays with every norm scale, ``A_log``, ``D``, ``dt_bias`` and ``lam``
drawn from a seed (the reference initialises them to constants, which
would hide their use), loaded into the port by
``convert.lm_params_from_numpy``.  Inputs come from numpy seeds.
Tolerances: float32 on both sides, sums in another order, so layer
functions and their caches at rtol 1e-5 (atol 1e-6 where an ``exp`` of
a segment sum sits near 0), whole-model logits at rtol/atol 1e-4, decode
against the port's own forward within the reference's 2e-2
(``tests/test_models.py``), greedy tokens exact.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in an xdist worker)

import repro.models as jm
from repro.configs.common import reduced as j_reduced
from repro.configs.registry import all_arch_ids as j_all_arch_ids
from repro.configs.registry import get_config as j_get_config
from repro.models import attention as jattn
from repro.models import flash as jflash
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.models.config import ModelConfig as JConfig
from repro.serving.serve_step import make_serve_step as j_make_serve_step
from repro_torch import models as tm
from repro_torch.configs import all_arch_ids, get_config, reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import blocks as tblocks
from repro_torch.models import flash as tflash
from repro_torch.models import layers as tl
from repro_torch.models import rglru as trglru
from repro_torch.models import ssm as tssm
from repro_torch.serving import Engine, make_serve_step

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
FAMILIES = ("mamba2-370m", "recurrentgemma-2b", "internvl2-26b", "hubert-xlarge")
RECURRENT = ("mamba2-370m", "recurrentgemma-2b")
DRAWN = {"scale": (0.0, 0.3), "A_log": (0.0, 0.5), "D": (1.0, 0.3),
         "dt_bias": (0.0, 0.5), "lam": (1.0, 0.3)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, rtol, atol=0.0):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


def _model(arch, seed=3):
    """(cfg, jcfg, tree, jparams, port lm) of the reduced ``arch`` on one
    set of weights."""
    cfg = reduced(get_config(arch))
    jcfg = JConfig(**dataclasses.asdict(cfg))
    tree = jax.tree.map(np.array, jm.init_lm(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = getattr(path[-1], "key", None)
        if name in DRAWN:
            mean, std = DRAWN[name]
            return (mean + std * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    tree = jax.tree_util.tree_map_with_path(draw, tree)
    return (cfg, jcfg, tree, jax.tree.map(jnp.asarray, tree),
            lm_params_from_numpy(cfg, tree, device=CPU))


@pytest.fixture(scope="module")
def models():
    return {arch: _model(arch) for arch in FAMILIES}


def _layer_tree(tree, cfg, i):
    from repro_torch.models.stack import find_period

    p, n_full, _ = find_period(cfg.block_pattern)
    if i < n_full * p:
        return jax.tree.map(lambda a: a[i // p], tree["stack"]["scan"][f"b{i % p}"])
    return tree["stack"]["tail"][i - n_full * p]


def _batch(cfg, s_text, seed=1, frames=8):
    """(port batch, reference batch): ``s_text`` tokens after the
    frontend's positions (8 patches for internvl2, ``frames`` frames and
    no tokens for hubert)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend_len < 0:
        s_text = 0
    toks = rng.integers(0, cfg.vocab_size, size=(2, s_text)).astype(np.int32)
    batch = {"tokens": toks}
    if cfg.frontend:
        n = frames if cfg.frontend_len < 0 else cfg.frontend_len
        batch["frontend_embeds"] = rng.standard_normal(
            (2, n, cfg.d_model)).astype(np.float32)
    return ({k: _t(v) for k, v in batch.items()},
            {k: jnp.asarray(v) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_family_configs_match_reference(arch):
    full, jfull = get_config(arch), j_get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert full.param_count() == jfull.param_count()
    assert (dataclasses.asdict(reduced(full))
            == dataclasses.asdict(j_reduced(jfull)))


def test_all_arch_ids_match_reference():
    assert all_arch_ids() == j_all_arch_ids()
    for arch in all_arch_ids():
        assert get_config(arch).name == arch
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", FAMILIES)
def test_param_count_matches_reference(models, arch):
    _cfg, _jcfg, _tree, jparams, lm = models[arch]
    assert tm.param_count(lm) == jm.param_count(jparams)


def test_recurrentgemma_pattern_and_caches():
    """26 layers: 8 periods of (R, R, A) and a tail (R, R); each layer's
    cache by its kind, float32 state and the cache type's conv history."""
    cfg = get_config("recurrentgemma-2b")
    assert cfg.block_pattern == ("rglru", "rglru", "attn_local") * 8 + (
        "rglru", "rglru")
    small = reduced(cfg)
    cache = tm.init_cache(small, 2, 32, torch.bfloat16, device=CPU)
    jcache = jm.init_cache(JConfig(**dataclasses.asdict(small)), 2, 32,
                           jnp.bfloat16)
    kinds = small.block_pattern
    assert [sorted(c) for c in cache] == [
        ["conv", "h"] if k == "rglru" else ["k", "slot_pos", "v"] for k in kinds]
    for i, (c, k) in enumerate(zip(cache, kinds)):
        jc = (jax.tree.map(lambda a: a[0], jcache["scan"][f"b{i}"]) if i < 3
              else jcache["tail"][i - 3])
        for name, t in c.items():
            assert tuple(t.shape) == jc[name].shape, (i, name)
            assert str(t.dtype).split(".")[-1] == str(jc[name].dtype), (i, name)


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

def test_segsum_and_causal_conv_match_reference():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((2, 3, 8)).astype(np.float32)
    port, ref = tssm._segsum(_t(a)), np.asarray(jssm._segsum(jnp.asarray(a)))
    assert np.array_equal(np.isinf(port.numpy()), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(port.numpy()[fin], ref[fin], rtol=1e-5, atol=1e-6)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    _close(tssm._causal_conv(_t(w), _t(x)),
           jssm._causal_conv(jnp.asarray(w), jnp.asarray(x)), rtol=1e-5, atol=1e-6)
    _close(tl.causal_conv(_t(w), _t(x)),
           jrglru._conv_causal(jnp.asarray(w), jnp.asarray(x)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("s", [20, 5])   # a padded tail chunk; S < chunk
def test_ssd_forward_matches_reference(models, s):
    cfg, jcfg, tree, _jp, lm = models["mamba2-370m"]
    x = np.random.default_rng(s).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    params = jax.tree.map(jnp.asarray, _layer_tree(tree, cfg, 1)["ssd"])
    ref = jssm.ssd_forward(jcfg, params, jnp.asarray(x))
    port = tssm.ssd_forward(cfg, lm.stack.layers[1].ssd, _t(x))
    assert port.shape == (2, s, cfg.d_model)
    _close(port, ref, rtol=1e-5, atol=1e-6)


def test_ssd_decode_matches_reference(models):
    """12 steps (past the conv history of 3): outputs, ``h`` and ``conv``."""
    cfg, jcfg, tree, _jp, lm = models["mamba2-370m"]
    xs = np.random.default_rng(7).standard_normal((12, 2, 1, cfg.d_model)).astype(np.float32)
    params = jax.tree.map(jnp.asarray, _layer_tree(tree, cfg, 0)["ssd"])
    jcache = jssm.init_ssd_cache(jcfg, 2, jnp.float32)
    cache = tssm.init_ssd_cache(cfg, 2, torch.float32, device=CPU)
    for t in range(12):
        ref, jcache = jssm.ssd_decode(jcfg, params, jcache, jnp.asarray(xs[t]), t)
        port, cache = tssm.ssd_decode(cfg, lm.stack.layers[0].ssd, cache,
                                      _t(xs[t]), t)
        _close(port, ref, rtol=1e-5, atol=1e-6)
    for name in ("h", "conv"):
        assert cache[name].dtype == torch.float32
        _close(cache[name], jcache[name], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 2, 3, 8, 37, 64])
def test_scan_matches_associative_scan(s):
    """The odd/even recursion against ``jax.lax.associative_scan`` on the
    RG-LRU's combine, and against the sequential recurrence."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.2, 1.0, (2, s, 5)).astype(np.float32)
    b = rng.standard_normal((2, s, 5)).astype(np.float32)

    def combine(lhs, rhs):
        return lhs[0] * rhs[0], rhs[1] + rhs[0] * lhs[1]

    ja, jh = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)),
                                      axis=1)
    pa, ph = trglru._scan(_t(a), _t(b))
    _close(pa, ja, rtol=1e-6, atol=1e-7)
    _close(ph, jh, rtol=1e-6, atol=1e-7)
    h, seq = np.zeros((2, 5), np.float32), []
    for i in range(s):
        h = a[:, i] * h + b[:, i]
        seq.append(h)
    _close(ph, np.stack(seq, axis=1), rtol=1e-5, atol=1e-6)


def test_rglru_forward_matches_reference(models):
    cfg, jcfg, tree, _jp, lm = models["recurrentgemma-2b"]
    x = np.random.default_rng(37).standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    params = jax.tree.map(jnp.asarray, _layer_tree(tree, cfg, 1)["rec"])
    ref = jrglru.rglru_forward(jcfg, params, jnp.asarray(x))
    port = trglru.rglru_forward(cfg, lm.stack.layers[1].rec, _t(x))
    _close(port, ref, rtol=1e-5, atol=1e-6)


def test_rglru_decode_matches_reference(models):
    cfg, jcfg, tree, _jp, lm = models["recurrentgemma-2b"]
    xs = np.random.default_rng(8).standard_normal((12, 2, 1, cfg.d_model)).astype(np.float32)
    params = jax.tree.map(jnp.asarray, _layer_tree(tree, cfg, 3)["rec"])
    jcache = jrglru.init_rglru_cache(jcfg, 2, jnp.float32)
    cache = trglru.init_rglru_cache(cfg, 2, torch.float32, device=CPU)
    for t in range(12):
        ref, jcache = jrglru.rglru_decode(jcfg, params, jcache, jnp.asarray(xs[t]), t)
        port, cache = trglru.rglru_decode(cfg, lm.stack.layers[3].rec, cache,
                                          _t(xs[t]), t)
        _close(port, ref, rtol=1e-5, atol=1e-6)
    for name in ("h", "conv"):
        _close(cache[name], jcache[name], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# blocks and the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["ssd", "rglru"])
def test_recurrent_block_refuses_kv(kind):
    cfg = reduced(get_config("mamba2-370m" if kind == "ssd" else "recurrentgemma-2b"))
    blk = tblocks.Block(cfg, kind, torch.Generator().manual_seed(0), CPU)
    x = torch.zeros(1, 4, cfg.d_model)
    pos = torch.arange(4, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="no K/V"):
        blk(x, pos, collect_kv=True)
    assert blk(x, pos).shape == x.shape


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_and_prefill_match_reference(models, arch):
    cfg, jcfg, _tree, jparams, lm = models[arch]
    batch, jbatch = _batch(cfg, 20)
    ref, _aux = jm.forward(jparams, jcfg, jbatch, remat=False)
    port = tm.forward(lm, batch)
    n_front = batch["frontend_embeds"].shape[1] if cfg.frontend else 0
    assert port.shape == (2, n_front + batch["tokens"].shape[1], cfg.padded_vocab)
    _close(port, ref, rtol=1e-4, atol=1e-4)
    _close(tm.prefill(lm, batch), np.asarray(ref)[:, -1], rtol=1e-4, atol=1e-4)


def test_frontend_embeds_prefix_and_scale():
    """The frontend rows come first, cast to the working type and scaled
    by sqrt(d_model) only under ``emb_scale``."""
    cfg = reduced(get_config("internvl2-26b"))
    for scale in (False, True):
        c = dataclasses.replace(cfg, emb_scale=scale, dtype="bfloat16")
        lm = tm.init_lm(c, generator=torch.Generator().manual_seed(1), device=CPU)
        fe = torch.randn(1, 3, c.d_model)
        x = tm.model._embed_inputs(lm, {"tokens": torch.tensor([[4, 9]]),
                                        "frontend_embeds": fe})
        want = fe.to(torch.bfloat16) * (c.d_model ** 0.5 if scale else 1.0)
        assert x.dtype == torch.bfloat16 and x.shape == (1, 5, c.d_model)
        assert torch.equal(x[:, :3], want)


@pytest.mark.parametrize("path", ["direct", "chunked"])
def test_encoder_attention_head_dim_80(path, monkeypatch):
    """hubert's non-causal attention at its head_dim of 80 against the
    reference, on the direct path and on the chunked path (forced by a
    lower threshold on both sides)."""
    from repro_torch.models import attention as tattn

    cfg = dataclasses.replace(reduced(get_config("hubert-xlarge")), head_dim=80)
    jcfg = JConfig(**dataclasses.asdict(cfg))
    if path == "chunked":
        monkeypatch.setattr(tattn, "DIRECT_ATTN_MAX_SEQ", 16)
        monkeypatch.setattr(jattn, "DIRECT_ATTN_MAX_SEQ", 16)
    lm = tm.init_lm(cfg, generator=torch.Generator().manual_seed(2), device=CPU)
    attn = lm.stack.layers[0].attn
    params = {f"w{n}": {"w": jnp.asarray(getattr(attn, f"w{n}").numpy())}
              for n in "qkvo"}
    s = 40
    x = np.random.default_rng(9).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    ref = jattn.attention(params, jcfg, "attn", jnp.asarray(x), jnp.asarray(pos),
                          encoder=True)
    _close(attn(_t(x), _t(pos)), ref, rtol=1e-5, atol=1e-5)
    if path == "chunked":
        q = np.random.default_rng(10).standard_normal((2, s, 4, 80)).astype(np.float32)
        kw = dict(causal=False, q_chunk=16, kv_chunk=8)
        _close(tflash.chunked_attention(_t(q), _t(q), _t(q), _t(pos), _t(pos), **kw),
               jflash.chunked_attention(*map(jnp.asarray, (q, q, q, pos, pos)), **kw),
               rtol=1e-5, atol=1e-5)


def _jit_decode(jcfg):
    return jax.jit(lambda p, c, tok, t: jm.decode_step(p, jcfg, c, tok, t))


@pytest.mark.parametrize("arch", RECURRENT)
def test_decode_step_matches_reference_and_forward(models, arch):
    """24 decode steps (past recurrentgemma's reduced window of 16):
    logits equal the reference's decode, and, within the reference's own
    2e-2, the port's forward at every position."""
    cfg, jcfg, _tree, jparams, lm = models[arch]
    steps = 24
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, steps)).astype(np.int32)
    full = tm.forward(lm, {"tokens": _t(toks)})
    jdecode = _jit_decode(jcfg)
    jcache = jm.init_cache(jcfg, 2, 32, jnp.float32)
    cache = tm.init_cache(cfg, 2, 32, torch.float32, device=CPU)
    for t in range(steps):
        ref, jcache = jdecode(jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                              jnp.int32(t))
        port, cache = tm.decode_step(lm, cache, _t(toks[:, t:t + 1]), t)
        _close(port, ref, rtol=1e-4, atol=1e-4)
        assert float((port - full[:, t]).abs().max()) < 2e-2


@pytest.mark.parametrize("arch", RECURRENT)
def test_serve_step_greedy_tokens_match_reference(models, arch):
    """8 teacher-forced prompt steps, then 12 greedy steps fed back."""
    cfg, jcfg, _tree, jparams, lm = models[arch]
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, size=(2, 8)).astype(np.int32)
    jstep, step = jax.jit(j_make_serve_step(jcfg)), make_serve_step(cfg)
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


def test_internvl2_decodes_from_a_fresh_cache(models):
    """The frontend config decodes tokens as the reference does (its
    decode takes no frontend rows)."""
    cfg, jcfg, _tree, jparams, lm = models["internvl2-26b"]
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, size=(2, 6)).astype(np.int32)
    jdecode = _jit_decode(jcfg)
    jcache = jm.init_cache(jcfg, 2, 8, jnp.float32)
    cache = tm.init_cache(cfg, 2, 8, torch.float32, device=CPU)
    for t in range(6):
        ref, jcache = jdecode(jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                              jnp.int32(t))
        port, cache = tm.decode_step(lm, cache, _t(toks[:, t:t + 1]), t)
        _close(port, ref, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# what is refused, by name
# ---------------------------------------------------------------------------

def test_hubert_init_cache_raises(models):
    cfg, jcfg, *_ = models["hubert-xlarge"]
    with pytest.raises(ValueError, match="encoder-only"):
        tm.init_cache(cfg, 1, 8, device=CPU)
    with pytest.raises(AssertionError, match="encoder-only"):
        jm.init_cache(jcfg, 1, 8)


@pytest.mark.parametrize("arch", ["internvl2-26b", "hubert-xlarge"])
def test_engine_refuses_frontend_f13(models, arch):
    cfg, *_rest, lm = models[arch]
    with pytest.raises(ValueError, match="F13"):
        Engine(cfg, lm, max_len=64, page_size=8, pool_pages=8,
               dtype=torch.float32, device=CPU)


@pytest.mark.parametrize("arch", RECURRENT)
def test_engine_refuses_recurrent_stacks(models, arch):
    cfg, *_rest, lm = models[arch]
    eng = Engine(cfg, lm, max_len=64, page_size=8, pool_pages=8,
                 dtype=torch.float32, device=CPU)
    prompts = np.zeros((1, 16), np.int32)
    with pytest.raises(ValueError, match="homogeneous global-attention"):
        eng.generate(prompts, 2)


@pytest.mark.parametrize("what", ["renamed", "extra"])
def test_convert_refuses_a_tree_of_other_names(models, what):
    cfg, _jcfg, tree, *_ = models["recurrentgemma-2b"]
    bad = jax.tree.map(lambda a: a, tree)
    layer = bad["stack"]["tail"][0]
    if what == "renamed":
        layer["rec"]["gate"] = layer["rec"].pop("gate_in")
    else:
        layer["ssd"] = layer["rec"]
    with pytest.raises(ValueError, match="layer 3"):
        lm_params_from_numpy(cfg, bad, device=CPU)


# ---------------------------------------------------------------------------
# the serving launcher twin
# ---------------------------------------------------------------------------

def _serve(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def test_serve_launcher_runs_reduced_starcoder2_on_cpu():
    r = _serve("--arch", "starcoder2-3b", "--reduced", "--device", "cpu",
               "--prompt-len", "64", "--max-new", "4", "--rounds", "2")
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert lines[0].startswith("round 0: prefill computed 128 cached 0;")
    assert lines[1].startswith("round 1: prefill computed 0 cached 128;")


@pytest.mark.parametrize("arch,why", [
    ("hubert-xlarge", "encoder-only"),
    ("internvl2-26b", "F13"),
    ("mamba2-370m", "homogeneous global-attention"),
])
def test_serve_launcher_refuses_by_name(arch, why):
    from repro_torch.launch import serve

    with pytest.raises(ValueError, match=why):
        serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--prompt-len", "32", "--max-new", "2", "--rounds", "1"])
