"""The port's production layout and dry run against the JAX package on
the CPU: the assigned shapes, ``applicable``, ``input_specs`` and the
parameter counts (``configs``, ``models/config.py``); every parameter's,
optimizer moment's, batch array's and decode-cache leaf's shard shape by
``launch/shardings.py`` against the reference's ``fix_spec(param_spec)``
rules on both production meshes and both profiles; the roofline's
formulas; ``collective_bytes_of``; dry-run cells in fake worlds of 512
and 256 ranks; the (2, 2)-sharded forward and train step on 4 gloo
ranks; and there the expert-parallel MoE layer (``models/moe_ep.py``)
against the single-process port and ``repro.models.moe``.

The reference's rules build ``NamedSharding``s, which need a JAX mesh of
256 or 512 devices; here its ``NamedSharding`` is swapped for one that
returns the spec, on a stand-in mesh with the production axis names and
sizes, and a shard's shape is each dim over its axes' sizes.  The port's
shapes come from ``local_shape`` on a real ``DeviceMesh`` in
``fake_world``.  The roofline's constants differ by design (the H100's,
not the reference's TPU's): the formulas are held, with each package's
own constants.
"""
import dataclasses
import functools
import math
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in an xdist worker)
from jax.sharding import PartitionSpec as P

import repro.configs as jconfigs
import repro.launch.shardings as jsh
import repro.models as jm
import repro.optim.adamw as jadamw
import repro.roofline.analysis as jroof
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_param_paths
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.shardings import (
    batch_placements,
    cache_placements,
    local_shape,
    opt_state_placements,
    params_placements,
)
from repro_torch.models import init_lm
from repro_torch.optim import init_opt_state
from repro_torch.roofline import analysis as troof

ROOT = Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"
ARCHS = tconfigs.all_arch_ids()
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
PROFILES = ("fsdp_tp", "tp2d")


class _StandIn:
    """What the reference's rules read of a mesh: axis names and the
    devices' shape."""

    def __init__(self, multi_pod: bool):
        shape, names = MESHES[multi_pod]
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


@pytest.fixture
def ref_specs(monkeypatch):
    """The reference's sharding functions return PartitionSpecs."""
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)


def _shard_shape(spec, shape, multi_pod: bool) -> tuple:
    sizes = dict(zip(MESHES[multi_pod][1], MESHES[multi_pod][0]))
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for d, e in zip(shape, entries):
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        n = math.prod(sizes[a] for a in axes)
        assert d % n == 0
        out.append(d // n)
    return tuple(out)


def _node(tree, path: str):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str):
    cfg = jconfigs.get_config(arch)
    return jax.eval_shape(lambda: jm.init_lm(cfg, jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _port_lm(arch: str):
    return init_lm(tconfigs.get_config(arch), generator=torch.Generator(),
                   device="meta")


@functools.lru_cache(maxsize=None)
def _ref_inputs(arch: str, shape: str):
    return jconfigs.input_specs(jconfigs.get_config(arch), shape)


def _cells():
    return [(a, s) for a in ARCHS for s in tconfigs.SHAPES
            if tconfigs.applicable(tconfigs.get_config(a), s)[0]]


def _port_mesh(multi_pod: bool):
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


# ---------------------------------------------------------------------------
# configs and counts
# ---------------------------------------------------------------------------

def test_shapes_match_reference():
    assert list(tconfigs.SHAPES) == list(jconfigs.SHAPES)
    for name, s in tconfigs.SHAPES.items():
        assert dataclasses.astuple(s) == dataclasses.astuple(jconfigs.SHAPES[name])
    from repro.configs.common import LONG_CONTEXT_ARCHS

    assert tconfigs.LONG_CONTEXT_ARCHS == LONG_CONTEXT_ARCHS


def test_applicable_matches_reference():
    """All 10 archs x 4 shapes, reasons word for word."""
    seen = set()
    for arch in ARCHS:
        for shape in tconfigs.SHAPES:
            got = tconfigs.applicable(tconfigs.get_config(arch), shape)
            assert got == jconfigs.applicable(jconfigs.get_config(arch), shape)
            seen.add(got[1])
    assert len(seen) == 3          # runs, encoder-only, full attention


def test_input_specs_match_reference():
    """Shapes and dtypes of every input of every applicable cell; the
    port's per-layer decode cache against the reference's stacked tree
    (a scanned layer's leaf is the stacked leaf without its period
    axis)."""
    from repro_torch.models.stack import find_period

    for arch, shape in _cells():
        cfg = tconfigs.get_config(arch)
        got = tconfigs.input_specs(cfg, shape)
        want = _ref_inputs(arch, shape)
        assert set(got) == set(want), (arch, shape)
        for k, x in got.items():
            if k == "cache":
                continue
            assert x.device.type == "meta"
            assert tuple(x.shape) == tuple(want[k].shape), (arch, shape, k)
            assert str(x.dtype).split(".")[-1] == str(want[k].dtype), (arch, k)
        if "cache" not in got:
            continue
        p, n_full, _ = find_period(cfg.block_pattern)
        for i, layer in enumerate(got["cache"]):
            for k, x in layer.items():
                if i < n_full * p:
                    ref = want["cache"]["scan"][f"b{i % p}"][k]
                    ref_shape = ref.shape[1:]
                else:
                    ref = want["cache"]["tail"][i - n_full * p][k]
                    ref_shape = ref.shape
                assert tuple(x.shape) == tuple(ref_shape), (arch, i, k)
                assert str(x.dtype).split(".")[-1] == str(ref.dtype), (arch, i, k)


def test_param_counts_match_reference():
    """The analytic counts, and the parameters each package holds (qk
    norms are held and not in the analytic count, in both)."""
    for arch in ARCHS:
        t, j = tconfigs.get_config(arch), jconfigs.get_config(arch)
        assert t.param_count() == j.param_count(), arch
        assert t.active_param_count() == j.active_param_count(), arch
        assert t.sub_quadratic == j.sub_quadratic, arch
        held = sum(math.prod(x.shape) for x in jax.tree.leaves(_ref_params(arch)))
        assert sum(p.numel() for p in _port_lm(arch).parameters()) == held, arch


# ---------------------------------------------------------------------------
# placements against the reference's rules
# ---------------------------------------------------------------------------

def _params_case(arch, multi_pod, profile, mesh):
    lm = _port_lm(arch)
    ref = jsh.params_shardings(_ref_params(arch), _StandIn(multi_pod), profile)
    pl = params_placements(lm, mesh, profile)
    shapes = {n: tuple(p.shape) for n, p in lm.named_parameters()}
    for name, (path, period) in lm_param_paths(lm).items():
        leaf = _node(_ref_params(arch), path)
        want = _shard_shape(_node(ref, path), leaf.shape, multi_pod)
        if period is not None:
            want = want[1:]
        assert local_shape(shapes[name], pl[name], mesh) == want, (arch, name)
    return len(shapes)


def _opt_state_case(arch, multi_pod, profile, mesh):
    """Moments and float32 masters shard like their parameters, step
    replicated (the reference's ``opt_state_shardings`` over
    ``init_opt_state(master=True)``)."""
    lm = _port_lm(arch)
    ref_p = _ref_params(arch)
    p_sh = jsh.params_shardings(ref_p, _StandIn(multi_pod), profile)
    ref_opt = jax.eval_shape(lambda p: jadamw.init_opt_state(p, master=True), ref_p)
    ref = jsh.opt_state_shardings(ref_opt, p_sh, _StandIn(multi_pod))
    params = {n: p for n, p in lm.named_parameters()}
    opt = init_opt_state({n: p.to(torch.bfloat16) for n, p in params.items()},
                         master=True)
    pl = opt_state_placements(opt, params_placements(lm, mesh, profile), mesh)
    assert tuple(ref["step"]) == () and all(
        not hasattr(q, "dim") for q in pl["step"])
    paths = lm_param_paths(lm)
    n = 0
    for kind in ("mu", "nu", "master"):
        for name, x in opt[kind].items():
            path, period = paths[name]
            leaf = _node(ref_opt[kind], path)
            want = _shard_shape(_node(ref[kind], path), leaf.shape, multi_pod)
            if period is not None:
                want = want[1:]
            assert local_shape(x.shape, pl[kind][name], mesh) == want, (arch, kind, name)
            n += 1
    return n


def _batch_case(arch, multi_pod, profile, mesh):
    n = 0
    for shape in ("train_4k", "prefill_32k"):
        cfg = tconfigs.get_config(arch)
        specs = tconfigs.input_specs(cfg, shape)
        ref_specs = _ref_inputs(arch, shape)
        ref = jsh.batch_shardings(ref_specs, _StandIn(multi_pod))
        pl = batch_placements(specs, mesh)
        for k, x in specs.items():
            want = _shard_shape(ref[k], ref_specs[k].shape, multi_pod)
            assert local_shape(x.shape, pl[k], mesh) == want, (arch, shape, k)
            n += 1
    return n


def _cache_case(arch, multi_pod, profile, mesh):
    from repro_torch.models.stack import find_period

    cfg = tconfigs.get_config(arch)
    n = 0
    for shape in ("decode_32k", "long_500k"):
        if not tconfigs.applicable(cfg, shape)[0]:
            continue
        batch = tconfigs.SHAPES[shape].batch
        seq_tp = profile == "tp2d"
        cache = tconfigs.input_specs(cfg, shape)["cache"]
        ref_cache = _ref_inputs(arch, shape)["cache"]
        ref = jsh.cache_shardings(ref_cache, _StandIn(multi_pod), batch,
                                  seq_over_tp=seq_tp)
        pl = cache_placements(cfg, cache, mesh, batch, seq_over_tp=seq_tp)
        p, n_full, _ = find_period(cfg.block_pattern)
        for i, layer in enumerate(cache):
            for k, x in layer.items():
                if i < n_full * p:
                    path = f"scan/b{i % p}/{k}"
                    cut = 1
                else:
                    path = f"tail/{i - n_full * p}/{k}"
                    cut = 0
                want = _shard_shape(_node(ref, path),
                                    _node(ref_cache, path).shape, multi_pod)[cut:]
                assert local_shape(x.shape, pl[i][k], mesh) == want, (arch, shape, i, k)
                n += 1
    return n


@pytest.mark.parametrize("family", ["params", "opt_state", "batch", "cache"])
def test_local_shapes_match_reference(family, ref_specs):
    """Every arch, both production meshes, both profiles: each leaf's
    shard shape on the port's mesh equals the reference spec's."""
    case = {"params": _params_case, "opt_state": _opt_state_case,
            "batch": _batch_case, "cache": _cache_case}[family]
    archs = ARCHS if family != "opt_state" else ("llama3-405b", "gemma3-12b",
                                                 "qwen3-moe-235b-a22b",
                                                 "mamba2-370m", "recurrentgemma-2b")
    checked = 0
    for multi_pod in (False, True):
        with fake_world(512 if multi_pod else 256):
            mesh = _port_mesh(multi_pod)
            for profile in PROFILES:
                for arch in archs:
                    checked += case(arch, multi_pod, profile, mesh)
    assert checked > 0


def test_two_mesh_dims_split_one_dim_pod_major():
    """(pod, data) on one tensor dim: device (pod p, data d) holds chunk
    p * 16 + d, as the reference's (pod, data) entry splits it."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset

    from repro_torch.launch.shardings import placements

    with fake_world(512):
        mesh = _port_mesh(True)
        pl = placements((("pod", "data"), "model"), mesh)
    assert pl == (Shard(0), Shard(0), Shard(1))
    for p, d, m in ((0, 0, 0), (1, 3, 5), (0, 15, 2), (1, 15, 15)):
        shape, offset = _compute_local_shape_and_global_offset(
            (1024, 64), (2, 16, 16), [p, d, m], pl)
        assert shape == (32, 4)
        assert offset == ((p * 16 + d) * 32, m * 4)


def test_activation_hints():
    """The residual and decode hints redistribute a 3-D DTensor to the
    installed placements; with none installed, on a plain tensor or on
    another rank they return their input; a hint for another mesh
    raises."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import act_sharding as A

    with fake_world(256):
        mesh = _port_mesh(False)
        x = distribute_tensor(torch.empty(256, 64, 32, device="meta"), mesh,
                              [Shard(0), Replicate()])
        plain = torch.empty(2, 3, 4)
        assert A.hint_residual(x) is x and A.hint_decode(x) is x
        A.set_activation_spec((mesh, (Shard(0), Shard(1))))
        A.set_decode_spec((mesh, (Replicate(), Shard(2))))
        try:
            assert A.hint_residual(x).placements == (Shard(0), Shard(1))
            assert A.hint_decode(x).placements == (Replicate(), Shard(2))
            assert A.hint_residual(plain) is plain
            flat = x[:, 0]
            assert A.hint_residual(flat) is flat
        finally:
            A.set_activation_spec(None)
            A.set_decode_spec(None)
    with fake_world(512):
        other = _port_mesh(True)
        y = distribute_tensor(torch.empty(512, 8, 8, device="meta"), other,
                              [Replicate()] * 3)
        A.set_activation_spec((mesh, (Shard(0), Shard(1))))
        try:
            with pytest.raises(ValueError):
                A.hint_residual(y)
        finally:
            A.set_activation_spec(None)


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

def test_roofline_matches_reference_formulas():
    """The same properties and keys; each term is the reference's with
    its constant swapped for the H100's."""
    args = dict(flops=3.1e18, hbm_bytes=7.7e15, coll_bytes=2.9e14, chips=256,
                model_flops=2.2e18)
    t, j = troof.Roofline(**args), jroof.Roofline(**args)
    assert set(t.as_dict()) == set(j.as_dict())
    assert t.t_compute == pytest.approx(j.t_compute * jroof.PEAK_FLOPS / troof.PEAK_FLOPS)
    assert t.t_memory == pytest.approx(j.t_memory * jroof.HBM_BW / troof.HBM_BW)
    assert t.t_collective == pytest.approx(j.t_collective * jroof.LINK_BW / troof.LINK_BW)
    assert t.useful_ratio == j.useful_ratio
    terms = {"compute": t.t_compute, "memory": t.t_memory,
             "collective": t.t_collective}
    assert t.bottleneck == max(terms, key=terms.get)
    assert t.step_time == max(terms.values())
    assert t.mfu == pytest.approx(args["model_flops"] / (t.step_time * 256 * troof.PEAK_FLOPS))
    assert troof.PEAK_FLOPS == 989.4e12 and troof.HBM_BW == 3.35e12
    assert troof.LINK_BW == troof.IB_BW < troof.NVLINK_BW
    assert troof.Roofline(0, 0, 0, 1).useful_ratio == 0.0


def test_overlap_speedup_bound_and_model_flops_match_reference():
    for tc, tr in ((1.0, 3.0), (2.5, 0.5), (0.0, 1.0), (1.0, 0.0), (0.0, 0.0)):
        assert troof.overlap_speedup_bound(tc, tr) == jroof.overlap_speedup_bound(tc, tr)
    for arch in ARCHS:
        for shape, s in tconfigs.SHAPES.items():
            assert troof.model_flops_for(tconfigs.get_config(arch), s.kind, s.seq,
                                         s.batch) == jroof.model_flops_for(
                jconfigs.get_config(arch), s.kind, s.seq, s.batch)


@pytest.mark.parametrize("kind,op,operand,output", [
    ("all_gather", "_c10d_functional.all_gather_into_tensor.default", 8 * 128 * 4, 32 * 128 * 4),
    ("all_reduce", "_c10d_functional.all_reduce.default", 1024 * 4, 1024 * 4),
    ("reduce_scatter", "_c10d_functional.reduce_scatter_tensor.default", 1024 * 4, 256 * 4),
    ("all_to_all", "_dtensor.shard_dim_alltoall.default", 4 * 64 * 22 * 4, 4 * 64 * 22 * 4),
    ("permute", "_c10d_functional.permute_tensor.default", 512, 512),
])
def test_collective_bytes_of(kind, op, operand, output):
    """One op of each kind, twice: max(operand, output) each time, the
    reference's rule; the other kinds stay 0."""
    got = troof.collective_bytes_of([(op, operand, output)] * 2)
    counts = got.pop("_counts")
    assert got[kind] == 2 * max(operand, output)
    assert counts[kind] == 2
    assert sum(got.values()) == got[kind] and sum(counts.values()) == 2
    with pytest.raises(ValueError):
        troof.collective_bytes_of([("aten.mm.default", 1, 1)])


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def _ref_decode_argument_bytes(arch: str, shape: str, multi_pod: bool) -> int:
    """The reference's per-leaf shard bytes of its decode cell's
    arguments (bf16 parameters, cache, tokens), as its ``build_cell``
    shards them: ``_shard_bytes`` without its ``del n`` fault.  The
    reference's ``t`` (an int32 scalar) is left out: the port passes the
    position as a host int."""
    mesh = _StandIn(multi_pod)
    cfg = jconfigs.get_config(arch)
    params = jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(
            s.shape, jnp.bfloat16 if jnp.issubdtype(s.dtype, jnp.floating) else s.dtype),
        _ref_params(arch))
    specs = _ref_inputs(arch, shape)
    batch = jconfigs.SHAPES[shape].batch
    trees = [(params, jsh.params_shardings(params, mesh)),
             (specs["cache"], jsh.cache_shardings(specs["cache"], mesh, batch)),
             ({"tokens": specs["tokens"]},
              jsh.batch_shardings({"tokens": specs["tokens"]}, mesh))]
    total = 0
    for shapes, sh in trees:
        leaves = jax.tree.leaves(shapes)
        spec_leaves = jax.tree.leaves(sh, is_leaf=lambda x: isinstance(x, P))
        assert len(leaves) == len(spec_leaves)
        for leaf, spec in zip(leaves, spec_leaves):
            total += math.prod(_shard_shape(spec, leaf.shape, multi_pod)) * leaf.dtype.itemsize
    return total


def test_run_cell_mamba2_decode_multi_pod(ref_specs):
    """The reference's own test cell in a fake world of 512: ok, 512
    chips, and the arguments' bytes on rank 0 equal the reference's
    per-leaf shard bytes; cost and collectives recorded."""
    cell = dryrun.run_cell("mamba2-370m", "decode_32k", multi_pod=True,
                           verbose=False)
    assert cell["ok"], cell.get("error")
    assert cell["chips"] == 512 and cell["mesh"] == "pod2x16x16"
    assert cell["memory"]["argument_bytes"] == _ref_decode_argument_bytes(
        "mamba2-370m", "decode_32k", True)
    assert cell["cost_per_device"]["flops"] > 0
    assert cell["cost_per_device"]["bytes accessed"] > 0
    assert cell["memory"]["temp_bytes"] > 0
    assert set(cell["collective_bytes_per_device"]) == {
        "all_gather", "all_reduce", "reduce_scatter", "all_to_all", "permute"}
    assert cell["model_flops"] == jroof.model_flops_for(
        jconfigs.get_config("mamba2-370m"), "decode", 32_768, 128)
    keys = {"arch", "shape", "mesh", "accum", "cast_bf16", "profile",
            "capacity_factor", "ok", "chips", "memory", "cost_per_device",
            "collective_bytes_per_device", "collective_counts", "model_flops",
            "active_params", "total_params"}
    assert keys <= set(cell)


def test_dryrun_cli_writes_skip_and_ok_records(tmp_path, monkeypatch):
    """``python -m repro_torch.launch.dryrun`` with the reference's flags:
    an encoder-only arch's decode cell is skipped with the reference's
    reason, a small cell is ok."""
    import json

    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "hubert-xlarge",
                                      "--shape", "decode_32k", "--out",
                                      str(tmp_path)])
    dryrun.main()
    cell = json.loads((tmp_path / "hubert-xlarge__decode_32k__sp.json").read_text())
    assert cell["skipped"] and cell["reason"] == jconfigs.applicable(
        jconfigs.get_config("hubert-xlarge"), "decode_32k")[1]
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "starcoder2-3b",
                                      "--shape", "decode_32k", "--out",
                                      str(tmp_path)])
    dryrun.main()
    cell = json.loads((tmp_path / "starcoder2-3b__decode_32k__sp.json").read_text())
    assert cell["ok"] and cell["chips"] == 256


# ---------------------------------------------------------------------------
# sharded execution on 4 gloo ranks
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def dtensor_ranks(tmp_path_factory):
    """tests/torch_dist_ranks.py's ``dtensor`` group on 4 gloo ranks."""
    import torch_dist_ranks as R

    out = tmp_path_factory.mktemp("dtensor_ranks")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(TESTS / "torch_dist_ranks.py"), "dtensor",
         str(r), str(R.DTENSOR_WORLD), str(port), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(R.DTENSOR_WORLD)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err.decode()[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [np.load(out / f"dtensor_rank{r}.npz") for r in range(R.DTENSOR_WORLD)]


def _single_process():
    import torch_dist_ranks as R
    from repro_torch.models import forward
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step

    cfg = tconfigs.reduced(tconfigs.get_config(R.DTENSOR_ARCH))
    lm = init_lm(cfg, generator=torch.Generator().manual_seed(R.DTENSOR_SEED),
                 device="cpu")
    lm.requires_grad_(True)
    full = {n: p.detach().numpy().copy() for n, p in lm.named_parameters()}
    batch = {k: torch.from_numpy(v)
             for k, v in R.dtensor_batch(cfg.vocab_size).items()}
    logits = forward(lm, {"tokens": batch["tokens"]}).numpy()
    state = init_opt_state(dict(lm.named_parameters()))
    lm, state, m = make_train_step(cfg, AdamWConfig(**R.TRAIN_OPT))(lm, state, batch)
    return cfg, lm, full, logits, float(m["loss"])


def _check_sharded_run(ranks, prefix: str) -> None:
    _cfg, lm, _full, logits, loss = _single_process()
    for got in ranks:
        np.testing.assert_allclose(got[f"{prefix}logits"], logits, atol=1e-5,
                                   rtol=0)
        assert abs(float(got[f"{prefix}loss"]) - loss) <= 1e-5
        for n, p in lm.named_parameters():
            np.testing.assert_allclose(got[f"{prefix}param/{n}"],
                                       p.detach().numpy(), atol=1e-5, rtol=0,
                                       err_msg=n)


def test_sharded_forward_and_step_match_single_process(dtensor_ranks):
    """The (data=2, model=2)-sharded forward's logits, one train step's
    loss (with ``grad_placements``) and the parameters after it equal the
    single-process port's within 1e-5, on every rank."""
    _check_sharded_run(dtensor_ranks, "")


def test_sharded_hinted_forward_and_step_match_single_process(dtensor_ranks):
    """The same with the dry run's sequence-parallel residual hint
    installed (``set_activation_spec``: batch over ``data``, sequence over
    ``model``), so that the path the dry run counts is checked for
    values: the hinted residual, the gathers before each matmul, the
    gradients pinned to their placements and the partial logits reduced
    onto the batch."""
    _check_sharded_run(dtensor_ranks, "hinted/")


def test_sharded_shards_hold_reference_elements(dtensor_ranks, ref_specs):
    """Rank r is device (data r // 2, model r % 2); its shard of each
    parameter is the full tensor sliced, in numpy, by the reference's
    spec for that device."""
    cfg, _lm, full, _logits, _loss = _single_process()
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get_config(cfg.name)),
                               name=cfg.name)
    ref_p = jax.eval_shape(lambda: jm.init_lm(jcfg, jax.random.PRNGKey(0)))
    stand = _StandIn(False)
    stand.devices = np.empty((2, 2), dtype=object)
    specs = jsh.params_shardings(ref_p, stand)
    sizes = {"data": 2, "model": 2}
    lm = init_lm(cfg, generator=torch.Generator(), device="meta")
    for r, got in enumerate(dtensor_ranks):
        coord = {"data": r // 2, "model": r % 2}
        for name, (path, period) in lm_param_paths(lm).items():
            spec = list(_node(specs, path))
            if period is not None:
                spec = spec[1:]
            x = full[name]
            for d, e in enumerate(spec):
                if e is None:
                    continue
                axes = e if isinstance(e, tuple) else (e,)
                idx, n = 0, 1
                for a in axes:
                    idx, n = idx * sizes[a] + coord[a], n * sizes[a]
                c = x.shape[d] // n
                x = np.take(x, np.arange(idx * c, (idx + 1) * c), axis=d)
            np.testing.assert_array_equal(got[f"shard/{name}"], x, err_msg=name)


# ---------------------------------------------------------------------------
# the expert-parallel MoE layer (models/moe_ep.py)
# ---------------------------------------------------------------------------

def _moe_case(arch: str, case: str):
    """(cfg, jcfg, tree, x) of a MoE case of the ``dtensor`` group."""
    import torch_dist_ranks as R
    from repro.models.config import ModelConfig as JConfig

    cfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch),
                                               n_layers=1),
                              expert_capacity_factor=R.MOE_CASES[case])
    tree, x = R.moe_layer_arrays(cfg.d_model, cfg.d_ff_expert, cfg.n_experts,
                                 bool(cfg.n_shared_experts), ties=case == "drop")
    return cfg, JConfig(**dataclasses.asdict(cfg)), tree, x


def _ref_routing(tree, jcfg, x, n_groups: int = 32):
    """The reference's routing lines of ``repro.models.moe.moe_forward``
    (its ``lax.top_k`` and its vmapped ``stable_rank_by_group``): the
    top-k experts (g, sg, k), bin positions and kept mask (g, sg*k)."""
    from repro.core.routing import stable_rank_by_group
    from repro.models import moe as jmoe

    b, s, e = x.shape
    k, nx = jcfg.experts_per_token, jcfg.n_experts
    g = jmoe._pick_groups(b * s, n_groups)
    sg = b * s // g
    cap = max(8, int(math.ceil(sg * k / nx * jcfg.expert_capacity_factor)))
    logits = jnp.einsum("gse,ex->gsx", jnp.asarray(x).reshape(g, sg, e),
                        jnp.asarray(tree["router"]["w"]))
    gate_all = jax.nn.softmax(logits, axis=-1)
    _gate_k, idx_k = jax.lax.top_k(gate_all, k)
    pos = jax.vmap(lambda d: stable_rank_by_group(d, n_groups=nx))(
        idx_k.reshape(g, sg * k))
    return (np.asarray(idx_k), np.asarray(pos), np.asarray(pos < cap),
            np.asarray(gate_all))


def _port_moe_params(tree):
    out = {n: {"w": torch.from_numpy(tree[n]["w"])}
           for n in ("router", "wi", "wg", "wo")}
    if "shared" in tree:
        out["shared"] = {n: torch.from_numpy(w["w"])
                         for n, w in tree["shared"].items()}
    return out


@pytest.mark.parametrize("case", ["nodrop", "drop"])
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"])
def test_sharded_moe_layer_matches_single_process_and_reference(
        dtensor_ranks, arch, case):
    """The expert-parallel layer on the (data=2, model=2) mesh, 2 experts
    a model rank, its input split over batch and sequence (``seq``: every
    group of two sequences spans both model ranks) or replicated over
    ``model`` (``rep``), against the single-process port and
    ``repro.models.moe.moe_forward`` on the same numpy-seeded weights and
    input.  Each rank's routing of its data shard's groups (the top-k
    experts, the bin positions and the kept mask) equals both bit for
    bit, in the drop case (capacity 8, experts 1 and 2 tied for every
    token) too, and so does the global drop count; ``y`` within 1e-5
    absolute (float32; a token's k contributions are summed per model
    rank, then across ranks) and ``aux_loss`` within 1e-6, in the
    input's placements.  The only all-gathers over ``model`` are of the
    layer's input (and, for the shared expert, of its own weights): no
    routed expert's weight is."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe

    cfg, jcfg, tree, x = _moe_case(arch, case)
    ref_y, ref_stats = jmoe.moe_forward(jax.tree.map(jnp.asarray, tree), jcfg,
                                        jnp.asarray(x))
    ref_idx, ref_pos, ref_kept, gate_all = _ref_routing(tree, jcfg, x)
    y, stats = tmoe.moe_forward(_port_moe_params(tree), cfg, torch.from_numpy(x))
    g = ref_idx.shape[0]
    cap = tmoe._capacity(cfg, x.shape[0] * x.shape[1] // g)
    port = tmoe.route(torch.from_numpy(tree["router"]["w"]), cfg,
                      torch.from_numpy(x).reshape(g, -1, cfg.d_model), cap)
    np.testing.assert_array_equal(port[2].numpy(), ref_idx)
    np.testing.assert_array_equal(port[3].numpy(), ref_pos)
    np.testing.assert_array_equal(port[4].numpy(), ref_kept)
    dropped = int(ref_stats["dropped"])
    assert int(stats["dropped"]) == dropped == int((~ref_kept).sum())
    assert (dropped > 0) == (case == "drop")
    if case == "drop":             # the tie is real: equal gates, 1 first
        assert np.array_equal(gate_all[..., 1], gate_all[..., 2])
    expert_sizes = {n * tree["wi"]["w"][0].size for n in (cfg.n_experts // 2,
                                                          cfg.n_experts)}
    for r, got in enumerate(dtensor_ranks):
        lo, hi = (r // 2) * g // 2, (r // 2 + 1) * g // 2    # data shard r // 2
        for layout, pl in (("seq", "(Shard(dim=0), Shard(dim=1))"),
                           ("rep", "(Shard(dim=0), Replicate())")):
            key = f"moe/{arch}/{case}/{layout}/"
            np.testing.assert_array_equal(got[key + "route/idx_k"], ref_idx[lo:hi])
            np.testing.assert_array_equal(got[key + "route/pos"], ref_pos[lo:hi])
            np.testing.assert_array_equal(got[key + "route/kept"], ref_kept[lo:hi])
            assert int(got[key + "dropped"]) == dropped
            np.testing.assert_allclose(got[key + "y"], y.numpy(), atol=1e-5, rtol=0)
            np.testing.assert_allclose(got[key + "y"], np.asarray(ref_y),
                                       atol=1e-5, rtol=0)
            np.testing.assert_allclose(got[key + "aux"], float(stats["aux_loss"]),
                                       atol=1e-6, rtol=0)
            np.testing.assert_allclose(got[key + "aux"],
                                       float(ref_stats["aux_loss"]),
                                       atol=1e-6, rtol=0)
            assert str(got[key + "placements"]) == pl
            gathers = set(got[key + "model_gathers"].tolist())
            assert not gathers & expert_sizes, (key, gathers)
            if layout == "seq":
                assert x[: x.shape[0] // 2].size in gathers


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"])
def test_sharded_moe_train_step_matches_single_process(dtensor_ranks, arch):
    """One train step of the reduced MoE LM (2 layers) under the dry run's
    sequence-parallel residual hint on the (2, 2) mesh: the loss (the aux
    loss in it) and every parameter after the step within 1e-5 of the
    single-process step's, on every rank (AdamW's eps at 1e-6, as
    ``torch_dist_ranks.MOE_TRAIN_OPT`` says why).  The batch's 30 groups
    of 12 tokens include one across each sequence's split between the
    model ranks."""
    import torch_dist_ranks as R
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step

    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    lm = init_lm(cfg, generator=torch.Generator().manual_seed(R.MOE_SEED),
                 device="cpu")
    lm.requires_grad_(True)
    batch = {k: torch.from_numpy(v)
             for k, v in R.moe_train_batch(cfg.vocab_size).items()}
    state = init_opt_state(dict(lm.named_parameters()))
    lm, state, m = make_train_step(cfg, AdamWConfig(**R.MOE_TRAIN_OPT))(
        lm, state, batch)
    key = f"moe_train/{arch}/"
    for got in dtensor_ranks:
        assert abs(float(got[key + "loss"]) - float(m["loss"])) <= 1e-5
        for n, p in lm.named_parameters():
            np.testing.assert_allclose(got[f"{key}param/{n}"],
                                       p.detach().numpy(), atol=1e-5, rtol=0,
                                       err_msg=n)


def test_moe_layer_refuses_layouts():
    """A layout the expert-parallel layer does not take raises
    ``ValueError`` naming it: groups that would span data-parallel
    shards, a batch that does not split over them, and expert weights
    split over their experts on different mesh dims."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.moe_ep import moe_forward

    cfg = tconfigs.reduced(tconfigs.get_config("qwen3-moe-235b-a22b"), n_layers=1)
    with fake_world(4):
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        lm = init_lm(cfg, generator=torch.Generator(), device="meta")
        from repro_torch.launch.shardings import distribute_lm

        distribute_lm(lm, mesh)
        moe = lm.stack.layers[0].moe

        def x(b, s):
            return distribute_tensor(torch.empty((b, s, cfg.d_model), device="meta"),
                                     mesh, [Shard(0), Shard(1)])

        with pytest.raises(ValueError, match="span data-parallel shards"):
            moe_forward(moe, cfg, x(2, 8), n_groups=1)
        with pytest.raises(ValueError, match="batch of 3"):
            moe_forward(moe, cfg, x(3, 8))
        params = {n: {"w": moe[n]["w"]} for n in ("router", "wi", "wg", "wo")}
        params["wo"] = {"w": params["wo"]["w"].redistribute(
            mesh, [Shard(0), Replicate()])}
        with pytest.raises(ValueError, match="same mesh dims"):
            moe_forward(params, cfg, x(2, 8))


def test_run_cell_llama4_scout_decode(ref_specs):
    """A MoE cell of the dry run in a fake world of 256: llama4-scout
    decode_32k is ok, its arguments' bytes on rank 0 equal the
    reference's per-leaf shard bytes, and its record has the MoE layers'
    collectives."""
    cell = dryrun.run_cell("llama4-scout-17b-a16e", "decode_32k",
                           multi_pod=False, verbose=False)
    assert cell["ok"], cell.get("error")
    assert cell["chips"] == 256
    assert cell["memory"]["argument_bytes"] == _ref_decode_argument_bytes(
        "llama4-scout-17b-a16e", "decode_32k", False)
    assert cell["cost_per_device"]["flops"] > 0
    assert cell["collective_bytes_per_device"]["all_reduce"] > 0
