"""The port's training stack against the JAX package on the CPU: AdamW
(``optim/adamw.py``: schedule, compression, the decay mask, masters),
``models.loss_fn`` and its gradients for every block kind, the train
step (microbatches, compression, ``cast_bf16``), the data-parallel step
and the int8 reduce-scatter on gloo ranks, the trainer's restart, and the
train launcher and quickstart twins.

Both sides get the same weights: ``repro.models.init_lm``'s tree as numpy
arrays with every norm scale and bias, ``A_log``, ``D``, ``dt_bias`` and
``lam`` drawn from a seed (the reference initialises them to constants,
which would hide their gradients), loaded into the port by
``convert.lm_params_from_numpy``; gradients and states come back through
``convert.lm_tree``/``opt_state_to_numpy``, leaf by leaf.  Inputs come
from numpy seeds.  Tolerances: float32 on both sides, sums in another
order: losses at rtol 1e-5; gradients within 2e-5 of each leaf's largest
magnitude; parameters after 3 AdamW steps at atol 2e-5 (an update moves
a weight by ~lr = 1e-3, so this is ~2% of one step's move).
"""
import dataclasses
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in an xdist worker)

import repro.models as jm
import repro.optim.adamw as jadamw
import repro.optim.compressed_reduce as jcr
import repro.train as jtrain
from repro.models.config import ModelConfig as JConfig
from repro_torch import models as tm
from repro_torch.configs import get_config, reduced
from repro_torch.convert import (
    lm_param_paths,
    lm_params_from_numpy,
    lm_params_to_numpy,
    lm_tree,
    opt_state_to_numpy,
)
from repro_torch.data import DataConfig, get_batch
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.train import make_train_step

ROOT = Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"
CPU = "cpu"
DRAWN = {"scale": (0.0, 0.3), "bias": (0.0, 0.1), "b": (0.0, 0.1),
         "A_log": (0.0, 0.5), "D": (1.0, 0.3), "dt_bias": (0.0, 0.5),
         "lam": (1.0, 0.3)}
# (arch, layers): one case per block kind
ARCHS = (("starcoder2-3b", 2), ("gemma3-12b", 2), ("qwen3-moe-235b-a22b", 2),
         ("mamba2-370m", 2), ("recurrentgemma-2b", 3), ("hubert-xlarge", 2))
SEQ = 24


def _cfg(arch: str, layers: int):
    cfg = reduced(get_config(arch), n_layers=layers)
    if arch == "gemma3-12b":
        # one local layer (window 16 < S) and one global: a period of 2
        cfg = dataclasses.replace(cfg, block_pattern=("attn_local", "attn"))
    return cfg


def _tree(jcfg, seed: int = 3) -> dict:
    tree = jax.tree.map(np.array, jm.init_lm(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = getattr(path[-1], "key", None)
        if name in DRAWN:
            mean, std = DRAWN[name]
            return (mean + std * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(draw, tree)


def _model(arch: str, layers: int):
    """(cfg, jcfg, tree, the port's lm with gradients on)."""
    cfg = _cfg(arch, layers)
    jcfg = JConfig(**dataclasses.asdict(cfg))
    tree = _tree(jcfg)
    lm = lm_params_from_numpy(cfg, tree, device=CPU)
    lm.requires_grad_(True)
    return cfg, jcfg, tree, lm


def _batch(cfg, seed: int = 1) -> dict:
    """numpy batch of 2 rows: ``SEQ`` tokens (hubert: 8 frames), labels
    with 5 positions of row 0 set to IGNORE."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(2, SEQ)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, size=(2, SEQ)).astype(np.int32)
    labels[0, :5] = tm.IGNORE
    batch = {"tokens": toks, "labels": labels}
    if cfg.frontend:
        n = 8 if cfg.frontend_len < 0 else cfg.frontend_len
        if cfg.frontend_len < 0:
            batch["tokens"], batch["labels"] = toks[:, :0], labels[:, :n]
        batch["frontend_embeds"] = rng.standard_normal(
            (2, n, cfg.d_model)).astype(np.float32)
    return batch


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for path, x in flat.items():
        *head, last = path.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = x
    return tree


def _leaves_close(port_tree, ref_tree, *, rel=None, atol=None, what=""):
    """Leaf by leaf in the reference's order: within ``rel`` of the
    leaf's largest magnitude, or within ``atol``."""
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    port_leaves = jax.tree.leaves(port_tree)
    assert len(ref_leaves) == len(port_leaves), what
    for (path, a), b in zip(ref_leaves, port_leaves):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape, (what, jax.tree_util.keystr(path))
        tol = atol if atol is not None else rel * max(float(np.abs(a).max()), 1e-30)
        err = float(np.abs(a - b).max())
        assert err <= tol, (what, jax.tree_util.keystr(path), err, tol)


# ---------------------------------------------------------------------------
# optim/adamw.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "linear", "const"])
def test_lr_at_matches_reference(schedule):
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                      schedule=schedule)
    jcfg = jadamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                              schedule=schedule)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        port = float(tadamw.lr_at(cfg, torch.tensor(step, dtype=torch.int32)))
        ref = float(jadamw.lr_at(jcfg, jnp.int32(step)))
        assert port == pytest.approx(ref, rel=1e-6, abs=1e-12), step


def test_compression_matches_reference():
    """compress_int8/decompress_int8 word for word, sparsify_topk's kept
    set, and the oracles of tests/test_optim.py."""
    rng = np.random.default_rng(0)
    g = (rng.normal(size=(256, 64)) * 3.0).astype(np.float32)
    q, s = tadamw.compress_int8(torch.from_numpy(g))
    jq, js = jadamw.compress_int8(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == pytest.approx(float(js), rel=1e-7)
    back = tadamw.decompress_int8(q, s)
    assert float((back - torch.from_numpy(g)).abs().max()) <= (
        np.abs(g).max() / 127.0 * 0.5 + 1e-6)
    for x, ratio in ((np.arange(100, dtype=np.float32) - 50.0, 0.1),
                     (g, 0.05)):
        port = tadamw.sparsify_topk(torch.from_numpy(x), ratio).numpy()
        np.testing.assert_array_equal(port, np.asarray(
            jadamw.sparsify_topk(jnp.asarray(x), ratio)))
    assert 0 in np.nonzero(tadamw.sparsify_topk(
        torch.arange(100.0) - 50.0, 0.1).numpy())[0]


@pytest.mark.parametrize("master", [False, True])
def test_apply_updates_matches_reference(master):
    """Three AdamW steps on the same arrays: parameters (bf16 working
    copies where ``master``), moments, masters and metrics.  ``scale`` and
    ``attn/wq/b`` exercise the decay mask's whole-key rule."""
    rng = np.random.default_rng(1)
    shapes = {"embed/table": (16, 8), "blk/ln1/scale": (8,),
              "blk/attn/wq/b": (2, 4), "blk/ssd/A_log": (3,)}
    vals = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in shapes.items()}
    dt = torch.bfloat16 if master else torch.float32
    jdt = jnp.bfloat16 if master else jnp.float32
    # copies: the update runs in place, and jnp.asarray may share memory
    params = {n: torch.tensor(v).to(dt) for n, v in vals.items()}
    state = tadamw.init_opt_state(params, master=master)
    # the reference's tree nests the same paths
    jparams = _nest({n: jnp.asarray(v).astype(jdt) for n, v in vals.items()})
    jstate = jadamw.init_opt_state(jparams, master=master)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    jcfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    for i in range(3):
        grads = {n: rng.standard_normal(s).astype(np.float32) * (i + 1)
                 for n, s in shapes.items()}
        m = tadamw.apply_updates(cfg, params, {n: torch.from_numpy(g).to(dt)
                                               for n, g in grads.items()},
                                 state)
        jparams, jstate, jm_ = jadamw.apply_updates(
            jcfg, jparams, _nest({n: jnp.asarray(g).astype(jdt)
                                  for n, g in grads.items()}), jstate)
        assert float(m["grad_norm"]) == pytest.approx(float(jm_["grad_norm"]),
                                                      rel=1e-5)
        assert float(m["lr"]) == pytest.approx(float(jm_["lr"]), rel=1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 3

    def at(tree, n):
        for k in n.split("/"):
            tree = tree[k]
        return np.asarray(tree, np.float32)

    for n in shapes:
        np.testing.assert_allclose(params[n].float().numpy(),
                                   at(jparams, n), rtol=1e-5, atol=1e-6)
        for k in ("mu", "nu"):
            np.testing.assert_allclose(state[k][n].numpy(), at(jstate[k], n),
                                       rtol=1e-5, atol=1e-7)
        if master:
            assert state["master"][n].dtype == torch.float32
            np.testing.assert_allclose(state["master"][n].numpy(),
                                       at(jstate["master"], n),
                                       rtol=1e-5, atol=1e-6)
    # the bias was decayed, the scale and A_log were not
    assert tadamw.decay_mask("blk/attn/wq/b")
    assert not tadamw.decay_mask("blk/ln1/scale")


@pytest.mark.parametrize("arch", ["starcoder2-3b", "gemma3-12b",
                                  "mamba2-370m", "recurrentgemma-2b",
                                  "qwen3-moe-235b-a22b"])
def test_decay_mask_leaf_by_leaf(arch):
    """The port's mask over ``lm_param_paths`` against the reference's
    ``_decay_mask`` over its own tree's paths, every leaf; a qkv bias
    (``attn/wq/b``) is decayed and a norm scale (``ln1/scale``) is not."""
    cfg = get_config(arch)
    cfg = reduced(cfg, n_layers=3 if arch == "recurrentgemma-2b" else 2)
    jcfg = JConfig(**dataclasses.asdict(cfg))
    shapes = jax.eval_shape(lambda: jm.init_lm(jcfg, jax.random.PRNGKey(0)))
    ref = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
           jadamw._decay_mask(path)
           for path, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    lm = tm.init_lm(cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    paths = lm_param_paths(lm)
    port = {path: tadamw.decay_mask(path) for path, _period in paths.values()}
    assert port == ref
    if cfg.qkv_bias:
        assert port["stack/scan/b0/attn/wq/b"]
    assert not port["stack/scan/b0/ln1/scale"]
    assert port["embed/table"]


# ---------------------------------------------------------------------------
# models.loss_fn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,layers", ARCHS, ids=[a for a, _ in ARCHS])
def test_loss_fn_value_and_grads_match_reference(arch, layers):
    """``loss_fn`` and its gradients against ``jax.value_and_grad`` of
    ``repro.models.loss_fn`` (remat on both sides), leaf by leaf: one
    case per block kind (layernorm/gelu/biases; local + global with
    post-norms and the tied head, window 16 < S = 24; MoE with its aux
    loss; SSD; RG-LRU; an encoder's frame labels)."""
    cfg, jcfg, tree, lm = _model(arch, layers)
    batch = _batch(cfg)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jcfg, {k: jnp.asarray(v)
                                       for k, v in batch.items()}),
        has_aux=True))(jax.tree.map(jnp.asarray, tree))
    loss, met = tm.loss_fn(lm, {k: torch.from_numpy(v) for k, v in batch.items()})
    params = dict(lm.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    assert float(met["aux_loss"]) == pytest.approx(float(jmet["aux_loss"]),
                                                   rel=1e-5, abs=1e-7)
    assert int(met["tokens"]) == int(jmet["tokens"])
    if arch.startswith("qwen3"):
        assert float(met["aux_loss"]) > 0
    _leaves_close(lm_tree(lm, dict(zip(params, grads))), jg, rel=2e-5,
                  what=arch)


def test_loss_fn_local_layers_take_the_kernel_path():
    """Training's local layers go through ``ops.local_attention``, once a
    local layer in the forward and once more in the remat recompute."""
    from repro_torch.kernels import ops

    cfg, _jcfg, _tree, lm = _model("gemma3-12b", 2)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    calls = []
    orig = ops.local_attention

    def counted(*a, **kw):
        calls.append(torch.is_grad_enabled())
        return orig(*a, **kw)

    ops.local_attention = counted
    try:
        loss, _ = tm.loss_fn(lm, batch)
        torch.autograd.grad(loss, list(lm.parameters()))
    finally:
        ops.local_attention = orig
    assert len(calls) == 2            # the forward and its recompute


# ---------------------------------------------------------------------------
# train/train_step.py
# ---------------------------------------------------------------------------

def _run_steps(cfg, jcfg, tree, ocfg_kw, *, accum=1, cast_bf16=False,
               steps=3, seq=16, batch=4):
    """``steps`` train steps on both sides from the same weights and
    batches: (port lm, port state, port losses, ref params, ref state,
    ref losses)."""
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch)
    lm = lm_params_from_numpy(cfg, tree, device=CPU)
    lm.requires_grad_(True)
    state = init_opt_state(dict(lm.named_parameters()))
    step = make_train_step(cfg, AdamWConfig(**ocfg_kw), accum=accum,
                           cast_bf16=cast_bf16)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jadamw.init_opt_state(jparams)
    jstep = jtrain.make_train_step(jcfg, jadamw.AdamWConfig(**ocfg_kw),
                                   accum=accum, donate=False,
                                   cast_bf16=cast_bf16)
    losses, jlosses = [], []
    for i in range(steps):
        raw = get_batch(dcfg, i)
        raw["labels"][0, :3] = tm.IGNORE
        lm, state, m = step(lm, state, {k: torch.from_numpy(v)
                                        for k, v in raw.items()})
        jparams, jstate, jmet = jstep(jparams, jstate,
                                      {k: jnp.asarray(v) for k, v in raw.items()})
        losses.append(float(m["loss"]))
        jlosses.append(float(jmet["loss"]))
    return lm, state, losses, jparams, jstate, jlosses


@pytest.fixture(scope="module")
def starcoder():
    cfg = _cfg("starcoder2-3b", 2)
    jcfg = JConfig(**dataclasses.asdict(cfg))
    return cfg, jcfg, _tree(jcfg)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(starcoder, accum):
    """3 steps of ``make_train_step`` against the reference's on the same
    weights and batches (3 labels of row 0 ignored): losses, parameters
    and moments leaf by leaf; with ``accum`` 2 the microbatches' float32
    gradients summed and halved."""
    cfg, jcfg, tree = starcoder
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    lm, state, losses, jparams, jstate, jlosses = _run_steps(
        cfg, jcfg, tree, kw, accum=accum)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    _leaves_close(lm_params_to_numpy(lm), jparams, atol=2e-5, what="params")
    ost = opt_state_to_numpy(lm, state)
    assert int(ost["step"]) == int(jstate["step"]) == 3
    _leaves_close(ost["mu"], jstate["mu"], rel=1e-4, what="mu")
    _leaves_close(ost["nu"], jstate["nu"], rel=1e-4, what="nu")


def test_cast_bf16_matches_reference(starcoder):
    """``cast_bf16``: every float32 weight read as its bf16 cast, in the
    forward and in the remat recompute, the gradient reaching the float32
    weight.  Against the reference's flag: the loss at rtol 1e-4 (without
    the cast it is 1.4e-3 away), each gradient leaf within 2^-5 of its
    largest magnitude (bf16 products rounded in another order: the
    measured worst is 1.2%), and 3 train steps' losses at rtol 1e-4.
    Parameters are not compared: Adam turns the sign of a gradient entry
    that bf16 rounding leaves near zero into a whole step of lr."""
    from repro_torch.train.train_step import _float32_as_bf16

    cfg, jcfg, tree = starcoder
    batch = _batch(cfg)

    def cast(p):
        return jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                            if x.dtype == jnp.float32 else x, p)

    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(cast(p), jcfg, {k: jnp.asarray(v)
                                             for k, v in batch.items()}),
        has_aux=True))(jax.tree.map(jnp.asarray, tree))
    lm = lm_params_from_numpy(cfg, tree, device=CPU)
    lm.requires_grad_(True)
    params = dict(lm.named_parameters())
    with _float32_as_bf16(lm):
        loss, _ = tm.loss_fn(lm, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
        grads = torch.autograd.grad(loss, list(params.values()))
    assert all(p.dtype == torch.float32 for p in lm.parameters())
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-4)
    _leaves_close(lm_tree(lm, dict(zip(params, grads))), jg, rel=2.0 ** -5,
                  what="cast_bf16 grads")
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    *_, losses, _jp, _js, jlosses = _run_steps(cfg, jcfg, tree, kw,
                                               cast_bf16=True)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)


@pytest.mark.parametrize("compression", ["int8", "topk"])
def test_training_with_compression_matches_reference(starcoder, compression):
    """The reference's ``test_training_with_compression_decreases_loss``
    on the port (lr 3e-3, top-k 0.2), its first 3 steps against the
    reference's.  The compressors are word for word the reference's on
    equal gradients (``test_compression_matches_reference``), but the
    gradients differ in their last bits, and an entry that lands across
    an int8 rounding edge or the top-k threshold moves by a whole
    quantization step or its whole value, which Adam turns into a move of
    up to lr.  So: the first loss at rtol 1e-5 (same weights), the next
    at rtol 1e-3 (measured: 1e-5 int8, 1.7e-4 top-k), the parameters
    within 3 lr (three steps' moves).  Then 12 steps lower the loss."""
    cfg, jcfg, tree = starcoder
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=20,
              compression=compression, topk_ratio=0.2)
    lm, state, losses, jparams, _jstate, jlosses = _run_steps(
        cfg, jcfg, tree, kw, seq=32, batch=8)
    assert losses[0] == pytest.approx(jlosses[0], rel=1e-5)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    _leaves_close(lm_params_to_numpy(lm), jparams, atol=9e-3, what="params")
    step = make_train_step(cfg, AdamWConfig(**kw))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    for i in range(3, 12):
        raw = get_batch(dcfg, i)
        lm, state, m = step(lm, state, {k: torch.from_numpy(v)
                                        for k, v in raw.items()})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses


def test_bf16_step_keeps_masters(starcoder):
    """A bf16 config: the matrices are bf16 working copies of float32
    masters (the state's ``master``), the float32 weights (norms, the
    table) have none; after a step each working copy is its master's
    cast, and the tied head is the new table's."""
    from repro_torch.train import make_train_state

    cfg = dataclasses.replace(starcoder[0], dtype="bfloat16")
    lm, state = make_train_state(cfg, torch.Generator().manual_seed(0),
                                 device=CPU)
    params = dict(lm.named_parameters())
    assert set(state["master"]) == {n for n, p in params.items()
                                    if p.dtype == torch.bfloat16}
    assert "embed" not in state["master"]
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    step = make_train_step(cfg, AdamWConfig(lr=1e-2, warmup_steps=1))
    batch = {k: torch.from_numpy(v) for k, v in get_batch(dcfg, 0).items()}
    before = {n: m.clone() for n, m in state["master"].items()}
    lm, state, m = step(lm, state, batch)
    assert np.isfinite(float(m["loss"]))
    for n, mast in state["master"].items():
        assert not torch.equal(mast, before[n]), n
        assert torch.equal(params[n], mast.to(torch.bfloat16)), n
    assert torch.equal(lm.head, lm.embed.detach().to(torch.bfloat16))


# ---------------------------------------------------------------------------
# gloo ranks: the data-parallel step and the compressed reduce
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def train_ranks(tmp_path_factory):
    """tests/torch_dist_ranks.py's ``train`` group on 2 gloo ranks and its
    ``creduce`` group on 4, all started at once."""
    out = tmp_path_factory.mktemp("train_ranks")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for group, world in (("train", 2), ("creduce", 4)):
        port = _free_port()
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, str(TESTS / "torch_dist_ranks.py"), group,
                 str(r), str(world), str(port), str(out)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err.decode()[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def test_data_parallel_step_matches_single_process(train_ranks):
    """2 gloo ranks, each with half of a batch of 4 and a different count
    of IGNORE labels (rank 0: 9, rank 1: 2), 2 steps: both ranks' losses
    and parameters equal the single-process step on the whole batch
    (float32, at rtol 1e-5 / atol 2e-5: the group's mean is taken in
    another order).  The loss is normalised by the global count; an
    average of per-rank means would differ."""
    import torch_dist_ranks as R

    cfg = reduced(get_config(R.TRAIN_ARCH), n_layers=2)
    lm = tm.init_lm(cfg, generator=torch.Generator().manual_seed(R.TRAIN_SEED),
                    device=CPU)
    lm.requires_grad_(True)
    state = init_opt_state(dict(lm.named_parameters()))
    step = make_train_step(cfg, AdamWConfig(**R.TRAIN_OPT))
    losses = []
    for batch in R.train_batches(cfg.vocab_size):
        lm, state, m = step(lm, state, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
        losses.append(float(m["loss"]))
    want = {n: p.detach().numpy() for n, p in lm.named_parameters()}
    for r in range(2):
        got = np.load(train_ranks / f"train_rank{r}.npz")
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        for n, w in want.items():
            np.testing.assert_allclose(got[f"param/{n}"], w, rtol=1e-5,
                                       atol=2e-5, err_msg=n)
    # per-rank means averaged would not be this loss
    b0 = R.train_batches(cfg.vocab_size)[0]
    ign = [(b0["labels"][r * 2:(r + 1) * 2] == tm.IGNORE).sum() for r in range(2)]
    assert ign[0] != ign[1]


def test_compressed_reduce_matches_reference(train_ranks):
    """4 gloo ranks: each rank's chunk of the int8 reduce-scatter against
    the reference's ``_quant``/``_dequant`` arithmetic on the same (R, n)
    gradients (each replica's chunks quantized, chunk r's R dequantized
    shares averaged), and within tests/test_compressed_reduce.py's bound
    of the float32 mean; ``wire_bytes`` equal."""
    import torch_dist_ranks as R

    from repro_torch.optim.compressed_reduce import wire_bytes

    grads = R.creduce_grads()
    world, n = grads.shape
    chunk = n // world
    qs, ss = zip(*(jcr._quant(jnp.asarray(g.reshape(world, chunk)))
                   for g in grads))
    expect = np.stack([
        np.asarray(sum(jcr._dequant(qs[src][r], ss[src][r])
                       for src in range(world)) / world)
        for r in range(world)])
    mean = grads.mean(axis=0).reshape(world, chunk)
    step = np.abs(grads).reshape(world, world, -1).max(-1) / 127.0
    bound = step.max() * 0.5 + 1e-6
    for r in range(world):
        got = np.load(train_ranks / f"creduce_rank{r}.npz")
        np.testing.assert_allclose(got["out"], expect[r], rtol=1e-6, atol=1e-7)
        assert np.abs(got["out"] - mean[r]).max() <= bound
        assert str(got["wire_dtype"]) == "torch.int8"
    assert wire_bytes(n, world) == jcr.wire_bytes(n, world)


# ---------------------------------------------------------------------------
# train/trainer.py and the entry points
# ---------------------------------------------------------------------------

def test_trainer_failure_restart_exact():
    """The twin of tests/test_substrate.py's trainer test: mamba2-370m
    reduced to 2 layers, a failure injected at step 8, a resume from the
    step-5 checkpoint, and the final parameters against an uninterrupted
    run at 1e-6; the checkpoint holds the reference's tree."""
    from repro_torch.checkpoint import latest_step
    from repro_torch.train import FailureInjector, TrainerConfig, run

    cfg = reduced(get_config("mamba2-370m"), n_layers=2)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    quiet = dict(log=lambda *_: None, device=CPU)
    with tempfile.TemporaryDirectory() as d:
        tcfg = TrainerConfig(total_steps=12, checkpoint_every=5,
                             checkpoint_dir=d, log_every=100)
        with pytest.raises(RuntimeError, match="injected failure"):
            run(cfg, dcfg, ocfg, tcfg, failure=FailureInjector(fail_at_step=8),
                **quiet)
        assert latest_step(d) == 5
        import json

        leaves = json.load(open(os.path.join(d, "step_5", "manifest.json")))
        assert "0/stack/scan/b0/ssd/A_log" in leaves["leaves"]
        assert "1/mu/embed/table" in leaves["leaves"]
        lm, _, hist = run(cfg, dcfg, ocfg, tcfg, **quiet)
        assert hist[0]["step"] == 11
    with tempfile.TemporaryDirectory() as d2:
        tcfg2 = TrainerConfig(total_steps=12, checkpoint_every=100,
                              checkpoint_dir=d2, log_every=100)
        ref, _, _ = run(cfg, dcfg, ocfg, tcfg2, **quiet)
    for (n, a), (_, b) in zip(lm.named_parameters(), ref.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-6, err_msg=n)


def test_train_launcher_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "starcoder2-3b", "--reduced", "--steps", "3", "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "step     2 loss" in out.stdout


def test_quickstart_twin_matches_reference():
    """``examples/torch_quickstart.py``'s stats equal
    ``examples/quickstart.py``'s (both on the CPU)."""
    sys.path.insert(0, str(ROOT))
    try:
        from examples import quickstart, torch_quickstart
    finally:
        sys.path.remove(str(ROOT))
    ref = quickstart.main(verbose=False)
    port = torch_quickstart.main(verbose=False, device=CPU)
    assert port == ref
    assert port["values_match"] and port["read_hits"] == port["n_items"]
