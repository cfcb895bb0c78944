"""Multi-pod dry run: every (architecture x input shape) cell on the
production meshes, on one host with no GPU -- the port of
``repro/launch/dryrun.py`` on DTensor.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun_torch

How a cell runs: ``fake_world(256 or 512)`` opens a fake process group in
which this process is rank 0 and collectives move nothing; the
production mesh is built over it (device type ``cpu``); the model, its
optimizer state and the batch or decode cache are made on the ``meta``
device (shapes and types, no memory) and distributed by the placements
of ``launch/shardings.py``.  Meta tensors, not ``FakeTensorMode``:
DTensor reads small index tensors of its own (a shard's offsets) back as
ints, which a fake mode cannot answer, while a tensor the model makes on
its input's device is a meta tensor too.  Then the cell's step -- the
train step, a prefill forward or a serve step -- runs eagerly through
DTensor (under ``implicit_replication``, which takes the tensors a
step makes itself as replicated): each op is planned on the global tensors and
run on rank 0's shards.  Nothing is launched on any device.  On a
``cpu`` mesh DTensor would turn an all-to-all into an all-gather (gloo
has none); the dry run issues the all-to-all, as the cluster's NCCL mesh
does.

Eager DTensor takes seconds a layer at these widths, so the step runs
on 1- and 2-period probes of the model and each count is extrapolated
over the periods (``extrapolated_costs``); the arguments are counted on
the whole model.  What is recorded, all of it rank 0's:
  - ``memory.argument_bytes``: the local bytes of every argument (by
    ``local_shape``); ``memory.temp_bytes``: the peak, during the step,
    of the bytes of the storages that the step's local ops allocated and
    that are still alive (each storage is counted when an op first
    returns it and dropped by a ``weakref`` finaliser when it is freed);
    ``memory.output_bytes``: what of those the step's outputs hold.
  - ``cost_per_device``: ``flops`` by ``FlopCounterMode``'s formulas on
    the local ops, and ``bytes accessed``, the input plus output bytes of
    every local aten op that is not a view or a collective: what an
    unfused eager program moves.
  - the collectives DTensor issued, as ``CommDebugMode`` saw them, in
    bytes (``roofline.collective_bytes_of``) and counts.
DTensor also runs each op on global-shaped ``FakeTensor``s to plan its
output; those ops are not rank 0's work and are not counted.

An op that DTensor cannot shard raises, and the cell records ``ok:
false`` with the op in ``error``; no op is replicated to get past it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.distributed.tensor import placement_types
from torch.distributed.tensor.debug import CommDebugMode
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from ..configs import SHAPES, all_arch_ids, applicable, get_config, input_specs
from ..models import forward, init_lm
from ..models.act_sharding import set_activation_spec, set_decode_spec
from ..models.config import ModelConfig
from ..models.stack import find_period
from ..optim.adamw import AdamWConfig, init_opt_state
from ..roofline.analysis import collective_bytes_of, model_flops_for
from ..serving.serve_step import make_serve_step
from ..train.train_step import make_train_step
from .mesh import dp_axes, fake_world, make_production_mesh, mesh_device_count
from .shardings import (
    batch_placements,
    cache_placements,
    distribute_lm,
    distribute_tree,
    local_shape,
    opt_state_placements,
    placements,
)

_VIEW_OPS = {"aten.detach.default", "aten.alias.default", "aten.lift_fresh.default"}


def _nbytes(x: torch.Tensor) -> int:
    """Rank 0's bytes of ``x``: a DTensor's local shard by its placements,
    a plain tensor whole."""
    if isinstance(x, DTensor):
        shape = local_shape(x.shape, x.placements, x.device_mesh)
    else:
        shape = x.shape
    n = 1
    for d in shape:
        n *= int(d)
    return n * x.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _tree_bytes(tree) -> int:
    return sum(_nbytes(x) for x in _tensors(tree))


class _Rank0Cost(TorchDispatchMode):
    """FLOPs, bytes accessed and live bytes of the local ops rank 0 runs.

    An op on DTensors is passed on (``NotImplemented``) so that DTensor
    turns it into local ops first, which come back here on rank 0's
    ``meta`` shards.  The ops DTensor runs on ``FakeTensor``s of the
    global shapes, to plan an op's output, are not rank 0's work and are
    skipped."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.last_op = None       # the last op on DTensors, for errors
        self._seen: weakref.WeakSet = weakref.WeakSet()
        self._flop = FlopCounterMode().flop_registry

    def _free(self, n: int) -> None:
        self.live -= n

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            if st in self._seen:
                continue
            self._seen.add(st)
            n = st.nbytes()
            self.live += n
            weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.live)

    def adopt(self, tree) -> None:
        """Storages that exist before the step (its arguments): never
        counted as allocated by it."""
        for x in _tensors(tree):
            x = x._local_tensor if isinstance(x, DTensor) else x
            self._seen.add(x.untyped_storage())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        flat = tree_flatten((args, kwargs))[0]
        if any(isinstance(a, DTensor) for a in flat):
            self.last_op = str(func)
            return NotImplemented
        out = func(*args, **kwargs)
        if any(isinstance(a, FakeTensor) for a in flat + _tensors(out)):
            return out
        name = str(func)
        packet = func._overloadpacket
        if packet in self._flop:
            self.flops += int(self._flop[packet](*args, **kwargs, out_val=out))
        collective = "c10d" in name or "_dtensor" in name
        view = getattr(func, "is_view", False) or name in _VIEW_OPS
        if not (collective or view):
            ins = {id(a): a for a in flat if isinstance(a, torch.Tensor)}
            self.bytes += sum(a.numel() * a.element_size() for a in ins.values())
            self.bytes += sum(o.numel() * o.element_size() for o in _tensors(out))
        self._track(out)
        return out


class _CommLog(CommDebugMode):
    """``CommDebugMode`` that also keeps each collective's operand and
    output bytes: ``ops`` holds ``(op name, operand bytes, output
    bytes)``."""

    def __init__(self):
        super().__init__()
        self.ops: list[tuple[str, int, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or isinstance(func, torch._ops.HigherOrderOperator):
            return out
        packet = func._overloadpacket
        if packet in self.comm_registry and "wait" not in str(func):
            operand = sum(t.numel() * t.element_size()
                          for t in _tensors((args, kwargs)))
            output = sum(t.numel() * t.element_size() for t in _tensors(out))
            self.ops.append((str(func), operand, output))
        return out


@contextlib.contextmanager
def _native_alltoall():
    """On a ``cpu`` mesh DTensor turns a shard-to-shard redistribution
    (an all-to-all) into an all-gather and a slice, because gloo has no
    all-to-all; on the production (NCCL) mesh it issues the all-to-all.
    For the span of the ``with`` the dry run issues it as NCCL would, so
    the record counts the collective the cluster runs.  Raises where this
    torch has no such hook (AttributeError): the dry run does not fall
    back to another program."""
    inner = placement_types.shard_dim_alltoall
    alltoall = torch.ops._dtensor.shard_dim_alltoall

    def native(input, gather_dim, shard_dim, mesh, mesh_dim):
        return alltoall(input, gather_dim, shard_dim,
                        mesh.get_group(mesh_dim).group_name)

    placement_types.shard_dim_alltoall = native
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = inner


def _cast_params(lm, dtype: torch.dtype) -> None:
    """Every floating parameter of ``lm`` stored in ``dtype``, in place
    (the reference's float32 parameters, or its ``_to_bf16``); the tied
    head made again."""
    for mod in lm.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None and p.is_floating_point() and p.dtype != dtype:
                mod._parameters[name] = torch.nn.Parameter(
                    p.detach().to(dtype), requires_grad=p.requires_grad)
    lm.refresh_head()


def _meta(tree):
    """``tree`` (dicts and lists of tensors) as ``meta`` tensors."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_meta(v) for v in tree]
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def build_cell(cfg: ModelConfig, shape_name: str, mesh, accum: int = 1,
               cast_bf16: bool = False, profile: str = "fsdp_tp"):
    """``(step, args)`` of one cell on ``mesh`` (``make_production_mesh``
    in a ``fake_world`` of its size), every tensor on the ``meta`` device.
    Parameters are float32 for
    training (bfloat16 with ``cast_bf16``, float32 masters in the
    optimizer state) and bfloat16 for prefill and decode, where the
    reference casts them; activations run in the config's type."""
    shape = SHAPES[shape_name]
    dp = dp_axes(mesh)
    set_activation_spec((mesh, placements((dp, "model", None), mesh)))

    specs = input_specs(cfg, shape_name)
    lm = init_lm(cfg, generator=torch.Generator(), device="meta")

    if shape.kind == "train":
        _cast_params(lm, torch.bfloat16 if cast_bf16 else torch.float32)
        lm.requires_grad_(True)
        p_pl = distribute_lm(lm, mesh)
        opt = _meta(init_opt_state(dict(lm.named_parameters()), master=cast_bf16))
        opt = distribute_tree(opt, mesh, opt_state_placements(opt, p_pl, mesh))
        batch = distribute_tree(specs, mesh, batch_placements(specs, mesh))
        step = make_train_step(cfg, AdamWConfig(), accum=accum,
                               cast_bf16=cast_bf16, grad_placements=p_pl)
        return step, (lm, opt, batch)

    _cast_params(lm, torch.bfloat16)
    if shape.kind == "prefill":
        distribute_lm(lm, mesh)
        batch = distribute_tree(specs, mesh, batch_placements(specs, mesh))

        def prefill_fn(lm, batch):
            return forward(lm, batch)[:, -1].to(torch.float32)

        return prefill_fn, (lm, batch)

    # decode
    distribute_lm(lm, mesh, profile)
    c_pl = cache_placements(cfg, specs["cache"], mesh, shape.batch,
                            seq_over_tp=(profile == "tp2d"))
    cache = distribute_tree(specs["cache"], mesh, c_pl)
    if profile == "tp2d":
        set_decode_spec((mesh, placements((None, None, dp), mesh)))
    tok_pl = batch_placements({"tokens": specs["tokens"]}, mesh)["tokens"]
    if shape.batch == 1:
        tok_pl = (Replicate(),) * mesh.ndim
    tokens = distribute_tensor(specs["tokens"], mesh, tok_pl)
    return make_serve_step(cfg), (lm, cache, tokens, shape.seq - 1)


def _arguments(args) -> list:
    """The tensors of a step's arguments: a model's parameters, dicts and
    lists of tensors."""
    out = []
    for a in args:
        if isinstance(a, torch.nn.Module):
            out += list(a.parameters())
        else:
            out += _tensors(a)
    return out


def _run_step(step, args, mesh) -> tuple[dict, dict, list]:
    """Run ``step(*args)`` once with rank 0's counters on; returns
    (memory, cost, collective ops).  A failure names the last op DTensor
    was given."""
    params = _arguments(args)
    cost = _Rank0Cost()
    comm = _CommLog()
    cost.adopt(params)
    try:
        with _native_alltoall(), implicit_replication(), comm, cost:
            out = step(*args)
    except Exception as e:
        raise RuntimeError(f"{cost.last_op}: {type(e).__name__}: {e}") from e
    outs = [x for x in _tensors(out) if not any(x is p for p in params)]
    memory = {
        "argument_bytes": sum(_nbytes(x) for x in params),
        "output_bytes": _tree_bytes(outs),
        "temp_bytes": cost.peak,
    }
    return memory, {"flops": float(cost.flops),
                    "bytes accessed": float(cost.bytes)}, comm.ops


def probe_cfg(cfg: ModelConfig, n_periods: int) -> ModelConfig:
    """The first ``n_periods`` periods of ``cfg``'s layer pattern."""
    p, _, _ = find_period(cfg.block_pattern)
    n = p * n_periods
    return dataclasses.replace(cfg, n_layers=n, block_pattern=cfg.block_pattern[:n])


def _probe(cfg, shape_name, mesh, accum, cast_bf16, profile):
    """memory, cost, collective bytes and counts of one run of the step."""
    step, args = build_cell(cfg, shape_name, mesh, accum, cast_bf16, profile)
    memory, cost, ops = _run_step(step, args, mesh)
    coll = collective_bytes_of(ops)
    return memory, cost, coll, coll.pop("_counts")


def extrapolated_costs(cfg, shape_name, mesh, accum=1, cast_bf16=False,
                       profile="fsdp_tp"):
    """The step run on 1-period and 2-period probes of ``cfg`` (eager
    DTensor takes seconds a layer at these widths, so a 126-layer model is
    not run whole), each metric extrapolated linearly over the periods,
    as the reference does for its scanned layers:

        total(metric) = probe1 + (n_full - 1 + tail/p) * (probe2 - probe1)

    exact for homogeneous periods.  A model of at most two periods is run
    whole.  Returns (temp bytes, output bytes, cost, collective bytes,
    counts, probes)."""
    p, n_full, tail = find_period(cfg.block_pattern)
    if n_full <= 2:
        mem, cost, coll, cnt = _probe(cfg, shape_name, mesh, accum,
                                      cast_bf16, profile)
        return mem, cost, coll, cnt, {}
    runs = [_probe(probe_cfg(cfg, n), shape_name, mesh, accum, cast_bf16,
                   profile) for n in (1, 2)]
    scale = (n_full - 1) + tail / p

    def ext(d1, d2):
        return {k: d1.get(k, 0) + scale * max(d2.get(k, 0) - d1.get(k, 0), 0)
                for k in set(d1) | set(d2)}

    (m1, c1, k1, n1), (m2, c2, k2, n2) = runs
    mem = ext({k: m1[k] for k in ("temp_bytes", "output_bytes")},
              {k: m2[k] for k in ("temp_bytes", "output_bytes")})
    probes = {f"probe{i}": {"memory": m, "cost": c, "coll": k}
              for i, (m, c, k, _n) in enumerate(runs, 1)}
    return mem, ext(c1, c2), ext(k1, k2), ext(n1, n2), probes


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             accum: int = 1, verbose: bool = True,
             cast_bf16: bool = False, profile: str = "fsdp_tp",
             capacity_factor: float | None = None) -> dict:
    """One cell's record (the reference's keys); never raises for a cell
    that fails: ``ok`` is false and ``error`` names the op.
    ``memory.argument_bytes`` is the whole model's; the temp and output
    bytes, the cost and the collectives come from the probes
    (``extrapolated_costs``)."""
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, expert_capacity_factor=capacity_factor)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "accum": accum, "cast_bf16": cast_bf16, "profile": profile,
            "capacity_factor": cfg.expert_capacity_factor, "ok": False}
    runs, why = applicable(cfg, shape_name)
    if not runs:
        cell.update({"skipped": True, "reason": why})
        return cell
    t0 = time.perf_counter()
    try:
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
            chips = mesh_device_count(mesh)
            _step, args = build_cell(cfg, shape_name, mesh, accum, cast_bf16,
                                     profile)
            arg_bytes = sum(_nbytes(x) for x in _arguments(args))
            del _step, args
            mem, cost, coll, counts, probes = extrapolated_costs(
                cfg, shape_name, mesh, accum, cast_bf16, profile)
        memory = {"argument_bytes": arg_bytes, **mem}
        if verbose:
            print(f"[{arch} x {shape_name} x {mesh_name}] memory:",
                  json.dumps(memory), flush=True)
            print(f"[{arch} x {shape_name} x {mesh_name}] cost (per device, "
                  f"extrapolated): flops={cost['flops']:.3e} "
                  f"bytes={cost['bytes accessed']:.3e}", flush=True)
        cell.update({
            "ok": True,
            "chips": chips,
            "run_s": time.perf_counter() - t0,
            "memory": memory,
            "cost_per_device": cost,
            "collective_bytes_per_device": coll,
            "collective_counts": counts,
            "probes": probes,
            "torch": torch.__version__,
            "model_flops": model_flops_for(cfg, shape.kind, shape.seq, shape.batch),
            "active_params": cfg.active_param_count(),
            "total_params": cfg.param_count(),
        })
    except Exception as e:  # a cell that fails is a result, not a crash
        cell.update({"error": f"{type(e).__name__}: {e}",
                     "traceback": traceback.format_exc()[-2000:]})
        if verbose:
            print(f"[{arch} x {shape_name} x {mesh_name}] FAILED: {e}", flush=True)
    finally:
        set_activation_spec(None)
        set_decode_spec(None)
    return cell


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--cast-bf16", action="store_true")
    ap.add_argument("--capacity-factor", type=float, default=None,
                    help="override MoE expert_capacity_factor")
    ap.add_argument("--profile", default="fsdp_tp",
                    choices=("fsdp_tp", "tp2d"))
    ap.add_argument("--suffix", default="",
                    help="output filename suffix for perf variants")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    archs = all_arch_ids() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                name = (f"{arch}__{shape}__{'mp' if mp else 'sp'}"
                        f"{args.suffix}.json")
                path = os.path.join(args.out, name)
                if os.path.exists(path):
                    print(f"skip existing {name}", flush=True)
                    continue
                cell = run_cell(arch, shape, mp, accum=args.accum,
                                cast_bf16=args.cast_bf16,
                                profile=args.profile,
                                capacity_factor=args.capacity_factor)
                with open(path, "w") as f:
                    json.dump(cell, f, indent=1)
                status = ("SKIP" if cell.get("skipped")
                          else "OK" if cell["ok"] else "FAIL")
                print(f"=== {name}: {status}", flush=True)


if __name__ == "__main__":
    main()
