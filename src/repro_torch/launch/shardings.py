"""Path-based sharding rules: parameter / optimizer / batch / cache
placements, the port of ``repro/launch/shardings.py`` on DTensor.

Baseline layout:
  - TP over `model`: attention heads, MLP hidden, experts (EP), vocab
  - FSDP over (`pod`,`data`): the non-TP major dim of every weight;
    optimizer moments shard identically (ZeRO-3)
  - DP over (`pod`,`data`): the batch dim of activations
  - decode caches: batch over DP when batch >= |DP|, else sequence over DP;
    KV heads over TP

The rules are the reference's, on the reference's path strings
(``convert.lm_param_paths`` gives each of the port's parameters its
path) and written as the reference writes a ``PartitionSpec``: a tuple
with one entry per tensor dim, each ``None``, an axis name or a tuple of
axis names.  ``placements`` turns such a spec into DTensor placements: a
dim sharded over an axis group such as (`pod`, `data`) is ``Shard(d)``
on each of the group's mesh dims, and DTensor splits it in mesh-dim
order, the reference's pod-major split.

The port holds one tensor per layer where the reference stacks the
periods of its layer scan on a leading axis; a stacked leaf's spec has
``None`` there, which ``fix_spec`` never fills, so the port's tensor
takes the rest of the spec.
"""
from __future__ import annotations

import math
from typing import Mapping

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Placement, Replicate, Shard, distribute_tensor

from ..convert import lm_param_paths
from ..models.stack import find_period
from .mesh import dp_axes, tp_axis

Spec = tuple  # one entry per tensor dim: None | axis | tuple of axes
Placements = tuple[Placement, ...]


def _axes(entry) -> tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


def _axes_size(mesh: DeviceMesh, entry) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return math.prod(sizes[a] for a in _axes(entry))


def fix_spec(spec: Spec, shape: tuple[int, ...], mesh: DeviceMesh) -> Spec:
    """Make a candidate spec valid for an *input* sharding: every sharded
    dim must divide evenly.  An axis that does not divide its dim shifts
    right to the next free divisible dim (e.g. KV heads 8 on a 16-way TP
    axis -> shard head_dim 128 instead); otherwise it drops."""
    n = len(shape)
    entries = list(spec) + [None] * (n - len(spec))
    out: list = [None] * n
    reserved = {i for i, e in enumerate(entries) if e is not None}
    for i, e in enumerate(entries):
        if e is None:
            continue
        size = _axes_size(mesh, e)
        for j in range(i, n):
            if out[j] is not None:
                continue
            if j != i and j in reserved:
                continue
            if shape[j] % size == 0 and shape[j] >= size:
                out[j] = e
                break
    return tuple(out)


def param_spec(path: str, shape: tuple[int, ...], fsdp, tp,
               profile: str = "fsdp_tp") -> Spec:
    """Logical spec for one parameter (before scan-stack adjustment).

    profiles:
      fsdp_tp -- baseline: weights stored sharded over (pod,data), gathered
                 at use; TP over model.  Right for training (weights move
                 once per traversal, amortized over the whole batch).
      tp2d    -- decode: weights *stay* sharded over BOTH axis groups and
                 matmuls run as distributed GEMMs (partial sums reduced via
                 activation-sized all-reduces).  Kills the per-token weight
                 all-gather that dominates decode."""
    parts = path.split("/")
    leaf = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""
    replicated = (None,) * len(shape)

    if profile == "tp2d":
        if leaf == "table":                   # (V, E)
            return (tp, fsdp)
        if parent in ("wq", "wk", "wv"):
            if leaf == "w":                   # (E, H, D): contract-dim 2D
                return (fsdp, tp, None)
            return (tp, None)
        if parent == "wo" and "attn" in path:
            return (tp, fsdp)                 # (H*D, E)
        if "moe" in path and parent in ("wi", "wg"):
            return (tp, fsdp, None)           # (X, E, F)
        if "moe" in path and parent == "wo":
            return (tp, fsdp, None)           # (X, F, E)
        if parent in ("wi", "wg", "in_proj", "gate_in", "sig_in"):
            return (fsdp, tp)                 # (E, F) contract over E
        if parent in ("wo", "out_proj", "out"):
            return (tp, fsdp)                 # (F, E)
        if parent in ("wa", "wx"):
            return (fsdp, tp)
        if parent == "conv":
            return (None, tp)
        return replicated

    if leaf == "table":                       # (V, E)
        return (tp, fsdp)
    if parent in ("wq", "wk", "wv"):
        if leaf == "w":                       # (E, H, D)
            return (fsdp, tp, None)
        return (tp, None)                     # bias (H, D)
    if parent == "wo" and len(shape) == 2 and "attn" in path:
        return (tp, fsdp)                     # (H*D, E)
    if parent == "router":
        return (fsdp, None)                   # (E, X)
    if "moe" in path and parent in ("wi", "wg"):
        return (tp, fsdp, None)               # (X, E, F) -- EP on experts
    if "moe" in path and parent == "wo":
        return (tp, None, fsdp)               # (X, F, E)
    if parent in ("wi", "wg"):
        return (fsdp, tp)                     # (E, F)
    if parent == "wo":
        return (tp, fsdp)                     # (F, E)
    if parent == "in_proj":                   # ssd (E, F)
        return (fsdp, tp)
    if parent == "out_proj":                  # ssd (di, E)
        return (tp, fsdp)
    if parent in ("gate_in", "sig_in"):       # rglru (E, W)
        return (fsdp, tp)
    if parent in ("wa", "wx"):                # rglru (W, W)
        return (None, tp)
    if parent == "out" and len(shape) == 2:   # rglru (W, E)
        return (tp, fsdp)
    if parent == "conv":                      # (W, C) depthwise
        return (None, tp)
    # norms, scalars, gates: replicate
    return replicated


def placements(spec: Spec, mesh: DeviceMesh) -> Placements:
    """A spec as DTensor placements, one per mesh dim: ``Shard(d)`` on
    every mesh dim named in entry ``d``, ``Replicate()`` on the rest.  An
    axis group must name its axes in mesh order (DTensor splits a dim
    over several mesh dims in that order)."""
    names = list(mesh.mesh_dim_names)
    out: list[Placement] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"axis group {entry} is not in mesh order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} used twice in {spec}")
            out[i] = Shard(d)
    return tuple(out)


def local_shape(shape, pl: Placements, mesh: DeviceMesh) -> tuple[int, ...]:
    """The shape of one device's shard (``NamedSharding.shard_shape``):
    each ``Shard(d)`` divides dim ``d`` by its mesh dim's size, which must
    divide it."""
    out = list(shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if out[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split {n} ways")
            out[p.dim] //= n
    return tuple(out)


def _stacked_spec(spec_fn, stacked: bool, shape, mesh) -> Spec:
    """The reference's spec of a leaf that it stacks over the periods of
    its layer scan (``stacked``) or holds as one tensor, for the port's
    tensor of ``shape``: the stacked leaf gets ``None`` on its leading
    axis before ``fix_spec``, and the port's tensor takes the rest."""
    if stacked:
        full = (1, *shape)
        return fix_spec((None, *spec_fn(tuple(shape))), full, mesh)[1:]
    return fix_spec(spec_fn(tuple(shape)), tuple(shape), mesh)


def param_specs(lm, mesh: DeviceMesh, profile: str = "fsdp_tp") -> dict[str, Spec]:
    """{parameter name: the reference's spec of its leaf}."""
    fsdp, tp = dp_axes(mesh), tp_axis(mesh)
    params = dict(lm.named_parameters())
    out = {}
    for name, (path, period) in lm_param_paths(lm).items():
        out[name] = _stacked_spec(
            lambda s, path=path: param_spec(path, s, fsdp, tp, profile),
            period is not None, params[name].shape, mesh)
    return out


def params_placements(lm, mesh: DeviceMesh,
                      profile: str = "fsdp_tp") -> dict[str, Placements]:
    """{parameter name: placements} by the reference's rules."""
    return {n: placements(s, mesh)
            for n, s in param_specs(lm, mesh, profile).items()}


def opt_state_placements(opt_state: dict, p_placements: Mapping[str, Placements],
                         mesh: DeviceMesh) -> dict:
    """Moments (and float32 masters) shard like their parameters; step is
    replicated.  Mirrors ``opt_state``'s structure."""
    out = {k: {n: p_placements[n] for n in v}
           for k, v in opt_state.items() if k != "step"}
    out["step"] = (Replicate(),) * mesh.ndim
    return out


def batch_placements(batch: Mapping[str, torch.Tensor],
                     mesh: DeviceMesh) -> dict[str, Placements]:
    """Each batch array's leading dim over the DP axes."""
    dp = dp_axes(mesh)
    return {k: placements(fix_spec((dp,) + (None,) * (x.dim() - 1),
                                   tuple(x.shape), mesh), mesh)
            for k, x in batch.items()}


def cache_spec(leafname: str, shape, mesh: DeviceMesh, batch: int,
               seq_over_tp: bool = False) -> Spec:
    """The reference's rule for one decode-cache leaf of its stacked
    shape: KV (L, B, len, Hk, D); ssd h (L, B, nh, hd, st); rglru h
    (L, B, W); conv (L, B, W, C); slot_pos (L, len).  A leaf of other
    rank (the reference's unstacked tail layers) is replicated.

    seq_over_tp: shard the context length over the TP axis (each device
    holds a slice of the KV history) instead of heads / head-dim."""
    dp, tp = dp_axes(mesh), tp_axis(mesh)
    dp_size = _axes_size(mesh, dp) if dp else 1
    batch_ok = batch >= dp_size and batch % dp_size == 0
    nd = len(shape)
    if leafname == "slot_pos":
        spec = (None,) * nd
    elif leafname in ("k", "v") and nd == 5:
        if seq_over_tp:
            spec = ((None, dp, tp, None, None) if batch_ok
                    else (None, None, (*(dp or ()), tp), None, None))
        else:
            spec = ((None, dp, None, tp, None) if batch_ok
                    else (None, None, dp, tp, None))
    elif leafname == "h" and nd == 5:          # stacked ssd state
        spec = (None, dp if batch_ok else None, tp, None, None)
    elif leafname == "h" and nd == 3:          # stacked rglru state (L,B,W)
        spec = (None, dp if batch_ok else None, tp)
    elif leafname == "conv" and nd == 4:
        spec = (None, dp if batch_ok else None, None, tp)
    else:
        spec = (None,) * nd
    return fix_spec(spec, tuple(shape), mesh)


def cache_placements(cfg, cache: list, mesh: DeviceMesh, batch: int,
                     seq_over_tp: bool = False) -> list[dict[str, Placements]]:
    """Placements of the port's decode cache (a list of per-layer dicts,
    ``init_cache``): a layer the reference stacks in its scan takes the
    stacked leaf's rule, a tail layer the rule of its own rank."""
    p, n_full, _tail = find_period(cfg.block_pattern)
    out = []
    for i, layer in enumerate(cache):
        stacked = i < n_full * p
        out.append({k: placements(
            cache_spec(k, (1, *x.shape), mesh, batch, seq_over_tp)[1:]
            if stacked else cache_spec(k, tuple(x.shape), mesh, batch,
                                       seq_over_tp), mesh)
            for k, x in layer.items()})
    return out


def distribute_lm(lm, mesh: DeviceMesh, profile: str = "fsdp_tp") -> dict[str, Placements]:
    """Make every parameter of ``lm`` a DTensor on ``mesh``, in place, by
    ``params_placements``; the tied head is made again from the
    distributed table.  Returns the placements."""
    pl = params_placements(lm, mesh, profile)
    for name, param in list(lm.named_parameters()):
        *owner, leaf = name.split(".")
        mod = lm.get_submodule(".".join(owner))
        dt = distribute_tensor(param.detach(), mesh, pl[name])
        mod._parameters[leaf] = nn.Parameter(dt, requires_grad=param.requires_grad)
    lm.refresh_head()
    return pl


def distribute_tree(tree, mesh: DeviceMesh, pl):
    """Each tensor of ``tree`` (dicts and lists of tensors: an optimizer
    state, a batch, a decode cache) a DTensor with the placements at the
    same place in ``pl``."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, mesh, pl[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [distribute_tree(v, mesh, q) for v, q in zip(tree, pl)]
    return distribute_tensor(tree, mesh, pl)
