"""The MoE layer on DTensor shards of a mesh: expert-parallel dispatch,
the twin of ``moe.moe_forward`` that a DTensor input goes to.

The reference shards its MoE layer through GSPMD: token groups ride the
data axes, experts the model axis.  Here the layout is read from the
parameters:

  - the mesh dims that split the experts (dim 0 of ``wi``/``wg``/``wo``,
    the model axis under ``launch.shardings``) are the expert-parallel
    (EP) dims.  On them the layer's input is gathered (an all-gather; a
    decode step's is replicated there already) and the expert weights
    stay where they are: a device runs only its own experts;
  - every other mesh dim is a data-parallel (DP) dim.  On it the input is
    split over the batch, and the weights are gathered, as every layer
    gathers its FSDP shards.

The routing runs in a ``local_map`` on each device's tokens: every group
of ``_pick_groups(B*S, n_groups)`` lies inside one DP shard, so each EP
rank of a DP shard computes that shard's routing and bin positions
bit for bit as the single-process layer does, then fills and runs only
the capacity slots of its own experts and weights each token-choice
routed there by its gate.  The result is a partial sum over the EP dims,
reduced back to the input's placements (a reduce-scatter onto a sequence
split, an all-reduce onto a replicated input).  The capacity rule, the
tie order of the top-k, the drop rule and the gate normalisation are
``moe.route``'s.  What differs from the single-process layer is the order
of sums: a token's k contributions are summed per EP rank in float32 and
the ranks' partial sums in the working type.

The stats come out global: ``dropped`` is the count over every group,
and ``aux_loss`` the mean over every group (density and mean gate summed
over the DP dims), with its gradient.  DTensor carries the gradients of
every redistribution, so the backward needs nothing of its own.

A layout the twin does not take raises ``ValueError`` naming it: expert
weights split over their experts on different mesh dims, experts that do
not divide their mesh dims, a batch that does not split over the DP dims,
and groups that would span two DP shards (``g % dp != 0``, in no
production cell).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from .layers import mlp
from .moe import _capacity, _pick_groups, experts, route


def _expert_dims(w: DTensor) -> tuple[int, ...]:
    return tuple(i for i, p in enumerate(w.placements)
                 if isinstance(p, Shard) and p.dim == 0)


def _layout(params, x: DTensor, n_groups: int):
    """``(ep dims, dp size, g)`` of the layer on ``x``'s mesh; raises
    ``ValueError`` for a layout the twin does not take."""
    names = ("wi", "wg", "wo")
    ws = [params[n]["w"] for n in names]
    if not all(isinstance(w, DTensor) for w in ws):
        raise ValueError("expert-parallel MoE takes DTensor expert weights; "
                         f"got {[type(w).__name__ for w in ws]}")
    mesh = x.device_mesh
    ep = _expert_dims(ws[0])
    layouts = {n: w.placements for n, w in zip(names, ws)}
    if any(_expert_dims(w) != ep for w in ws):
        raise ValueError("expert-parallel MoE needs wi, wg and wo split over "
                         f"their experts on the same mesh dims; got {layouts}")
    n_ep = math.prod(mesh.size(i) for i in ep)
    n_x = ws[0].shape[0]
    if n_x % n_ep:
        raise ValueError(f"{n_x} experts do not split over mesh dims {ep} "
                         f"of {n_ep} devices ({layouts['wi']})")
    dp = tuple(i for i in range(mesh.ndim) if i not in ep)
    n_dp = math.prod(mesh.size(i) for i in dp)
    b, s, _e = x.shape
    g = _pick_groups(b * s, n_groups)
    if b % n_dp:
        raise ValueError(f"a batch of {b} does not split over the "
                         f"data-parallel mesh dims {dp} of {n_dp} devices")
    if g % n_dp:
        raise ValueError(f"{g} token groups of {b * s // g} tokens would span "
                         f"data-parallel shards ({n_dp} of them on mesh dims "
                         f"{dp}): expert-parallel MoE takes groups inside "
                         "one shard")
    return ep, n_dp, g


def _ep_index(mesh, ep: tuple[int, ...]) -> int:
    """This device's chunk of the experts: DTensor splits one dim over
    several mesh dims in mesh-dim order."""
    coord = mesh.get_coordinate()
    idx = 0
    for i in ep:
        idx = idx * mesh.size(i) + coord[i]
    return idx


def _local(x, router_w, wi, wg, wo, *, cfg, gl, cap, x0, first):
    """One device's work: x (B', S, E), its ``gl`` groups whole; wi/wg/wo
    its own experts ``x0 ..`` after the FSDP gather.  Returns the partial
    y (B', S, E), the top-1 counts and gate sums (X,) float32 (the gate
    sums only where ``first``, 0 elsewhere, so the EP ranks' sum holds
    them once) and the drop count of this shard's groups."""
    b, s, e = x.shape
    sg = b * s // gl
    k = cfg.experts_per_token
    dev = x.device
    xt = x.reshape(gl, sg, e)
    gate_all, gate_k, idx_k, pos, kept = route(router_w, cfg, xt, cap)
    nl = wi.shape[0]
    group = torch.arange(gl, device=dev)[:, None]

    # this device's slots: (local expert, position), the rest to a dump slot
    dest = idx_k.reshape(gl, sg * k) - x0
    mine = kept & (dest >= 0) & (dest < nl)
    slot = torch.where(mine, dest * cap + torch.clamp(pos, max=cap - 1),
                       nl * cap)
    choice = torch.arange(sg * k, device=dev).expand(gl, sg * k)
    owner = torch.full((gl, nl * cap + 1), sg * k, dtype=torch.int64,
                       device=dev).scatter_(1, slot, choice)[:, :nl * cap]
    filled = owner < sg * k                         # kept slots are unique
    owner = torch.clamp(owner, max=sg * k - 1)
    buf = torch.where(filled[..., None], xt[group, owner // k], 0)
    out = experts(cfg, buf.reshape(gl, nl, cap, e), wi, wg, wo)

    # combine: each slot's output by its gate, summed per token in float32
    gate = torch.where(filled, gate_k.to(x.dtype).reshape(gl, sg * k)[
        group, owner], 0)
    wout = out.reshape(gl, nl * cap, e).float() * gate.float()[..., None]
    slot = torch.clamp(slot, max=nl * cap - 1).reshape(gl, sg, k)
    mine = mine.reshape(gl, sg, k)
    y = torch.zeros((gl, sg, e), dtype=torch.float32, device=dev)
    for j in range(k):
        y = y + torch.where(mine[..., j, None], wout[group, slot[..., j]], 0)

    top1 = F.one_hot(idx_k[..., 0], cfg.n_experts).to(torch.float32).sum((0, 1))
    gates = gate_all.sum(dim=(0, 1)) * (1.0 if first else 0.0)
    dropped = (~kept).sum().to(torch.int32)
    return y.to(x.dtype).reshape(b, s, e), top1, gates, dropped


def moe_forward(params, cfg, x: DTensor, *, n_groups: int = 32):
    """``moe.moe_forward`` on a DTensor ``x`` (B, S, E) and DTensor
    parameters: ``(y, {"aux_loss", "dropped"})``, ``y`` in ``x``'s
    placements, the stats replicated scalars."""
    ep, n_dp, g = _layout(params, x, n_groups)
    mesh = x.device_mesh
    t = x.shape[0] * x.shape[1]
    cap = _capacity(cfg, t // g)
    ep_idx = _ep_index(mesh, ep)
    n_local = params["wi"]["w"].shape[0] // math.prod(mesh.size(i) for i in ep)

    def on(ep_p, dp_p):
        return tuple(ep_p if i in ep else dp_p for i in range(mesh.ndim))

    tokens = on(Replicate(), Shard(0))
    whole = (Replicate(),) * mesh.ndim
    own = on(Shard(0), Replicate())
    gated = cfg.mlp_kind in ("swiglu", "geglu")
    # cast before the gather (a local op), as ``layers.dense`` does
    ws = [params[n]["w"].to(x.dtype)
          for n in (("wi", "wg", "wo") if gated else ("wi", "wo"))]

    def local(x, router_w, *ws):
        wi, wg, wo = ws if gated else (ws[0], None, ws[1])
        return _local(x, router_w, wi, wg, wo, cfg=cfg, gl=g // n_dp, cap=cap,
                      x0=ep_idx * n_local, first=ep_idx == 0)

    run = local_map(
        local,
        out_placements=(on(Partial(), Shard(0)), on(Replicate(), Partial()),
                        (Partial(),) * mesh.ndim, on(Replicate(), Partial())),
        in_placements=(tokens, whole) + (own,) * len(ws),
        in_grad_placements=(on(Partial(), Shard(0)), (Partial(),) * mesh.ndim)
        + (on(Shard(0), Partial()),) * len(ws),
        device_mesh=mesh, redistribute_inputs=True)
    xg = x.redistribute(mesh, tokens)       # the input gathered over EP
    y, top1, gates, dropped = run(xg, params["router"]["w"], *ws)

    back = [Replicate() if p.is_partial() else p for p in x.placements]
    y = y.redistribute(mesh, back)
    if "shared" in params:
        y = y + mlp(params["shared"], xg, cfg.mlp_kind).redistribute(mesh, back)
    density = top1.redistribute(mesh, whole) / t
    aux = cfg.n_experts * torch.sum(density * (gates.redistribute(mesh, whole) / t))
    return y, {"aux_loss": aux, "dropped": dropped.redistribute(mesh, whole)}
