"""Mixture-of-Experts layer with capacity-factor token dispatch: the port
of ``repro/models/moe.py``.

The dispatch is the sort-based capacity binning the DHT router uses
(``core.routing.stable_rank_by_group``: one substrate, two clients, as
DESIGN.md §3 says): tokens are ranked within their expert bin and
dropped past capacity (switch-style; a dropped token passes through the
residual).  The reference ranks each token group apart; the port ranks
every group in one sort over the key ``group * n_experts + expert``,
which gives the same ranks.

The expert products are three batched matmuls over every expert's
weights, as the reference computes them outside any Pallas kernel: a
decode step reads all of them.  On DTensor shards of a mesh the layer is
``moe_ep.moe_forward``, which shares ``route`` and ``experts`` with this
one.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..core.routing import stable_rank_by_group
from .layers import ParamTree, init_dense, init_mlp, mlp, weight


def init_moe(cfg, gen: torch.Generator, device=None) -> ParamTree:
    """Router ``router.w`` (E, X) float32 (std 0.02), experts ``wi.w``/
    ``wg.w`` (X, E, F) and ``wo.w`` (X, F, E) in ``cfg.dtype`` (std
    1/sqrt(fan-in); ``wg`` whatever the MLP kind, as in the reference),
    and with ``n_shared_experts`` a ``shared`` MLP of
    width ``F * n_shared_experts``: the reference's tree, as modules."""
    e, x = cfg.d_model, cfg.n_experts
    f = cfg.d_ff_expert or cfg.d_ff
    dt = getattr(torch, cfg.dtype)

    def experts(fan_in, fan_out):
        w = torch.randn((x, fan_in, fan_out), generator=gen,
                        dtype=torch.float32, device=device)
        return weight(w.mul_(1.0 / math.sqrt(fan_in)), dt)

    mods = {"router": weight(init_dense(gen, e, (x,), scale=0.02,
                                        device=device), torch.float32),
            "wi": experts(e, f), "wg": experts(e, f), "wo": experts(f, e)}
    if cfg.n_shared_experts:
        mods["shared"] = init_mlp(gen, e, f * cfg.n_shared_experts,
                                  cfg.mlp_kind, dt, device)
    return ParamTree(**mods)


def _pick_groups(t: int, want: int) -> int:
    g = min(want, t)
    while t % g:
        g -= 1
    return max(g, 1)


def _capacity(cfg, sg: int) -> int:
    """Slots of each (group, expert) bin for groups of ``sg`` tokens."""
    k, nx = cfg.experts_per_token, cfg.n_experts
    return max(8, int(math.ceil(sg * k / nx * cfg.expert_capacity_factor)))


def route(router_w: torch.Tensor, cfg, xt: torch.Tensor, cap: int):
    """The routing of tokens in groups, xt (g, sg, E): ``(gate_all (g, sg,
    X) float32, gate_k (g, sg, k) renormalised, idx_k (g, sg, k), pos (g,
    sg*k) int32, kept (g, sg*k))``.  Experts by ``lax.top_k``'s order
    (the largest gate first, on ties the lower expert); ``pos`` is each
    token-choice's rank in its (group, expert) bin, stable in token-major
    then choice order, and ``kept`` is ``pos < cap``."""
    g, sg, _e = xt.shape
    k, nx = cfg.experts_per_token, cfg.n_experts
    logits = torch.einsum("gse,ex->gsx", xt.to(torch.float32),
                          router_w.to(torch.float32))
    gate_all = torch.softmax(logits, dim=-1)
    gate_s, idx_s = torch.sort(gate_all, dim=-1, descending=True, stable=True)
    gate_k, idx_k = gate_s[..., :k], idx_s[..., :k]               # (g, sg, k)
    gate_k = gate_k / torch.clamp(gate_k.sum(-1, keepdim=True), min=1e-9)
    # positions within each (group, expert) bin from one sort
    dest = idx_k.reshape(g, sg * k)
    group = torch.arange(g, device=xt.device)[:, None]
    pos = stable_rank_by_group((group * nx + dest).reshape(-1),
                               n_groups=g * nx).reshape(g, sg * k)
    return gate_all, gate_k, idx_k, pos, pos < cap


def experts(cfg, buf: torch.Tensor, wi, wg, wo) -> torch.Tensor:
    """The expert FFN on the capacity slots, buf (g, X', cap, E) against
    weights of X' experts -> (g, X', cap, E), by ``cfg.mlp_kind``."""
    dt = buf.dtype
    hi = torch.einsum("gxce,xef->gxcf", buf, wi.to(dt))
    if cfg.mlp_kind in ("swiglu", "geglu"):
        hg = torch.einsum("gxce,xef->gxcf", buf, wg.to(dt))
        hg = (F.silu(hg) if cfg.mlp_kind == "swiglu"
              else F.gelu(hg, approximate="tanh"))
        hi = hg * hi
    else:
        hi = F.gelu(hi, approximate="tanh")
    return torch.einsum("gxcf,xfe->gxce", hi, wo.to(dt))


def moe_forward(params, cfg, x: torch.Tensor, *, n_groups: int = 32):
    """x: (B, S, E) -> ``(y (B, S, E), {"aux_loss", "dropped"})``.
    ``params`` is the module ``init_moe`` builds or a dict of the same
    layout.  Tokens dropped past capacity contribute 0 (the residual
    passes them through); the stats stay on the device.  A DTensor ``x``
    goes to the expert-parallel twin (``moe_ep.moe_forward``)."""
    if isinstance(x, DTensor):
        from .moe_ep import moe_forward as moe_forward_ep

        return moe_forward_ep(params, cfg, x, n_groups=n_groups)
    b, s, e = x.shape
    t = b * s
    k = cfg.experts_per_token
    nx = cfg.n_experts
    g = _pick_groups(t, n_groups)
    sg = t // g
    cap = _capacity(cfg, sg)
    dev = x.device

    xt = x.reshape(g, sg, e)
    gate_all, gate_k, idx_k, pos, kept = route(params["router"]["w"], cfg,
                                               xt, cap)

    # load-balance aux loss (switch-style)
    density = F.one_hot(idx_k[..., 0], nx).to(torch.float32).mean(dim=(0, 1))
    aux = nx * torch.sum(density * gate_all.mean(dim=(0, 1)))

    dest = idx_k.reshape(g, sg * k)
    group = torch.arange(g, device=dev)[:, None]
    slot = dest * cap + torch.clamp(pos, max=cap - 1)             # (g, sg*k)
    slot = torch.where(kept, slot, nx * cap)                      # the dump row

    # dispatch: one scatter of the repeated tokens; kept slots are unique
    xk = torch.repeat_interleave(xt, k, dim=1)                    # (g, sg*k, e)
    buf = torch.zeros((g, nx * cap + 1, e), dtype=x.dtype, device=dev)
    buf[group, slot] = xk
    buf = buf[:, :nx * cap].reshape(g, nx, cap, e)

    out_buf = experts(cfg, buf, params["wi"]["w"], params["wg"]["w"],
                      params["wo"]["w"]).reshape(g, nx * cap, e)

    # combine: each token's k expert outputs, weighted in the compute dtype
    gathered = out_buf[group, torch.clamp(slot, max=nx * cap - 1)]
    gathered = torch.where(kept[..., None], gathered, 0).reshape(g, sg, k, e)
    y = torch.einsum("gske,gsk->gse", gathered, gate_k.to(x.dtype))

    if "shared" in params:
        y = y + mlp(params["shared"], xt, cfg.mlp_kind)

    stats = {"aux_loss": aux, "dropped": (~kept).sum().to(torch.int32)}
    return y.reshape(b, s, e), stats
