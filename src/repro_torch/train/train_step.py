"""The training step: loss -> gradients (remat, microbatch accumulation,
an optional data-parallel mean, optional compression) -> AdamW: the port
of ``repro/train/train_step.py``.

The model is an ``LM`` whose parameters require gradients
(``make_train_state``); the step updates them and the optimizer state in
place.  Weights stored in a working type other than float32 (every
matrix of a bf16 config) have float32 masters in the state, and the
update runs on the masters: the gradient the reference's float32
parameter gets through its cast at use is the working copy's gradient
cast to float32, and its update is the master's, so the step is the
reference's float32-parameter step.  Norm scales, the embedding table,
the router, ``A_log``, ``D``, ``dt_bias`` and ``lam`` are float32 and are
updated in place.

``grad_placements`` is the reference's ``grad_shardings`` for a model
whose parameters are DTensors (``launch.shardings.distribute_lm``): each
gradient is redistributed to its parameter's placements before it is
summed and applied, so a partial sum over the data axes lands as a
reduce-scatter into the parameter's shard.  Not ported: ``donate`` tells
XLA to reuse buffers; the eager step updates in place.  Added: ``group``, a
``torch.distributed`` group for data parallelism; each rank takes its
share of the batch, the loss is normalised by the group's count of valid
labels, and the gradients are averaged over the group (in float32)
before compression.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..convert import lm_param_paths
from ..core.layout import resolve_device
from ..models import IGNORE, init_lm, loss_fn
from ..models.config import ModelConfig
from ..optim.adamw import (
    AdamWConfig,
    apply_updates,
    init_opt_state,
    maybe_compress_grads,
)


@contextlib.contextmanager
def _float32_as_bf16(lm):
    """Every float32 parameter of ``lm`` read as its bfloat16 cast (a node
    of the graph, so its gradient reaches the parameter) for the forward
    and the backward: the reference's ``cast_bf16``.  Recompute under
    remat runs inside it too."""
    swapped = []
    for mod in lm.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None and p.dtype == torch.float32:
                mod._parameters[name] = p.to(torch.bfloat16)
                swapped.append((mod, name, p))
    try:
        yield
    finally:
        for mod, name, p in swapped:
            mod._parameters[name] = p


def _micro(batch: dict, accum: int, device) -> list[dict]:
    """The batch's arrays on ``device``, split along dim 0 into ``accum``
    microbatches of equal size."""
    out = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    if accum == 1:
        return [out]
    n = next(iter(out.values())).shape[0]
    if n % accum:
        raise ValueError(f"a batch of {n} rows does not split into "
                         f"{accum} microbatches")
    return [{k: v.reshape((accum, n // accum) + tuple(v.shape[1:]))[i]
             for k, v in out.items()} for i in range(accum)]


def _to_placements(grads: tuple, names: list[str], grad_placements) -> tuple:
    """Each DTensor gradient redistributed to ``grad_placements[name]``."""
    if grad_placements is None:
        return grads
    return tuple(g.redistribute(g.device_mesh, grad_placements[n])
                 if isinstance(g, DTensor) else g
                 for n, g in zip(names, grads))


def make_train_step(model_cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    accum: int = 1, cast_bf16: bool = False, group=None,
                    grad_placements=None):
    """Returns ``step(lm, opt_state, batch) -> (lm, opt_state, metrics)``.

    ``batch`` arrays (``tokens``, ``labels``; ``frontend_embeds`` with a
    frontend) have leading dim the batch (this rank's share under a
    group); with ``accum > 1`` they are split into ``accum`` microbatches
    run one after another, their float32 gradients summed and divided by
    ``accum``, as the reference's scan does; each period group is
    rematerialised in the backward.  ``cast_bf16``: every float32
    parameter is cast to bfloat16 before use (the reference's flag).
    ``grad_placements`` ({parameter name: DTensor placements}): each
    gradient of a DTensor parameter is redistributed to them as it is
    computed.  ``metrics``: ``loss`` (the objective, aux loss included;
    the group's mean), ``grad_norm`` and ``lr``, tensors on the device."""

    def step(lm, opt_state, batch):
        params = dict(lm.named_parameters())
        names = list(params)
        paths = {n: p for n, (p, _period) in lm_param_paths(lm).items()}
        dev = lm.embed.device
        world = 1 if group is None else dist.get_world_size(group)
        micro = _micro(batch, accum, dev)
        grads, loss_sum = None, None
        for mb in micro:
            n_valid = None
            if group is not None:
                n = (mb["labels"] != IGNORE).sum().to(torch.float32)
                dist.all_reduce(n, group=group)
                n_valid = torch.clamp(n, min=1.0) / world
            cast = _float32_as_bf16(lm) if cast_bf16 else contextlib.nullcontext()
            with cast:
                loss, _m = loss_fn(lm, mb, n_valid=n_valid)
                g = torch.autograd.grad(loss, [params[n] for n in names])
            g = _to_placements(g, names, grad_placements)
            loss = loss.detach()
            if accum == 1 and group is None:
                grads = dict(zip(names, g))
            elif grads is None:
                grads = {n: x.to(torch.float32) for n, x in zip(names, g)}
            else:
                for n, x in zip(names, g):
                    grads[n].add_(x.to(torch.float32))
            loss_sum = loss if loss_sum is None else loss_sum + loss
            del g
        if accum > 1:
            grads = {n: x.div_(accum) for n, x in grads.items()}
        loss = loss_sum / accum
        if group is not None:
            for x in grads.values():
                dist.all_reduce(x, group=group)
                x.div_(world)
            dist.all_reduce(loss, group=group)
            loss = loss / world
        grads = maybe_compress_grads(opt_cfg, grads)
        metrics = apply_updates(opt_cfg, params, grads, opt_state, paths=paths)
        del grads
        lm.refresh_head()
        return lm, opt_state, {"loss": loss, **metrics}

    return step


def make_train_state(model_cfg: ModelConfig, generator: torch.Generator, *,
                     device=None, master: bool | None = None):
    """``(lm, opt_state)``: a model with random weights from ``generator``
    (on the card unless ``device`` names another), its parameters
    requiring gradients, and AdamW's state over its named parameters, with
    float32 masters for the weights stored in another type (``master``:
    default, where the config's type is not float32)."""
    lm = init_lm(model_cfg, generator=generator, device=resolve_device(device))
    lm.requires_grad_(True)
    if master is None:
        master = model_cfg.dtype != "float32"
    return lm, init_opt_state(dict(lm.named_parameters()), master=master)
