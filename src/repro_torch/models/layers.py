"""Shared building blocks on tensors: the port of ``repro/models/layers.py``.

Parameters are passed as mappings of tensors (an ``nn.ParameterDict`` in
the modules) with the reference's names.  The reference keeps float32
parameters and casts them to the working type at every use; the port
stores each matrix in the working type once (``cast_matrix``), which
gives the same numbers at half the memory in bfloat16, and keeps norm
scales in float32, where the reference's arithmetic reads them.
"""
from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from . import act_sharding

Params = Mapping[str, torch.Tensor]


def init_dense(gen: torch.Generator, in_dim: int, out_dims, *,
               scale: float | None = None, device=None) -> torch.Tensor:
    """float32 normal of shape ``(in_dim, *out_dims)``, std ``scale`` or
    ``1/sqrt(in_dim)`` (the reference's ``_init_dense``)."""
    std = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, *out_dims), generator=gen, dtype=torch.float32,
                    device=device)
    return w.mul_(std)


def init_norm(dim: int, device=None, kind: str = "rmsnorm") -> nn.ParameterDict:
    """float32 zeros: ``scale`` (and ``bias`` for layernorm)."""
    names = ("scale", "bias") if kind == "layernorm" else ("scale",)
    return nn.ParameterDict({n: nn.Parameter(
        torch.zeros(dim, dtype=torch.float32, device=device),
        requires_grad=False) for n in names})


def weight(w: torch.Tensor, dtype: torch.dtype) -> nn.ParameterDict:
    """The reference's ``{"w": W}`` entry, W stored in ``dtype``."""
    return nn.ParameterDict({"w": nn.Parameter(w.to(dtype),
                                               requires_grad=False)})


class ParamTree(nn.Module):
    """A reference-shaped tree as a module: its entries (parameters and
    sub-trees) read as ``params[name]``, so the functions that take the
    reference's parameter dicts take it too."""

    def __init__(self, **entries):
        super().__init__()
        for name, value in entries.items():
            setattr(self, name, value)

    def keys(self) -> list[str]:
        return ([n for n, _ in self.named_children()]
                + [n for n, _ in self.named_parameters(recurse=False)])

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self.keys()


def causal_conv(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time: x (B, S, C), w (W, C); the W taps
    unrolled in the reference's order of sums."""
    width, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + pad[:, i:i + s, :] * w[i]
    return out


def dense(w: torch.Tensor, x: torch.Tensor,
          b: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ W (+ b)``, W: (in, *out), contracting the last axis of x."""
    if isinstance(w, DTensor) or isinstance(x, DTensor):
        return act_sharding.dense(w, x, b)
    w = w.to(x.dtype)
    y = (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def norm(params: Params, x: torch.Tensor, kind: str = "rmsnorm",
         eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm or LayerNorm in float32 with the ``(1 + scale)`` form."""
    dt = x.dtype
    x = x.to(torch.float32)
    if kind == "rmsnorm":
        var = x.square().mean(dim=-1, keepdim=True)
        y = x * torch.rsqrt(var + eps) * (1.0 + params["scale"])
    else:
        mu = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, correction=0)
        y = ((x - mu) * torch.rsqrt(var + eps) * (1.0 + params["scale"])
             + params["bias"])
    return y.to(dt)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    # theta stays a Python scalar: a tensor made from it on the card would
    # be a host-to-device copy that waits for the stream at every call
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S).  Rotation by halves (the first
    D/2 features pair with the last D/2), not interleaved."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)        # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs       # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp(params: Params, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    """``wo(act(wg x) * wi x)`` (swiglu: silu, geglu: tanh-gelu) or
    ``wo(gelu(wi x))`` (gelu)."""
    if kind == "swiglu":
        h = F.silu(dense(params["wg"], x)) * dense(params["wi"], x)
    elif kind == "geglu":
        h = F.gelu(dense(params["wg"], x), approximate="tanh") * dense(params["wi"], x)
    elif kind == "gelu":
        h = F.gelu(dense(params["wi"], x), approximate="tanh")
    else:
        raise ValueError(f"unknown mlp kind {kind!r}")
    return dense(params["wo"], h)


def mlp_names(kind: str) -> tuple[str, ...]:
    return ("wi", "wg", "wo") if kind in ("swiglu", "geglu") else ("wi", "wo")


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, kind: str,
             dtype: torch.dtype, device=None) -> nn.ParameterDict:
    """The MLP's matrices ``wi``/``wg`` (E, F) and ``wo`` (F, E), drawn as
    ``init_dense`` draws them, stored in ``dtype``."""
    shapes = {"wi": (d_model, d_ff), "wg": (d_model, d_ff), "wo": (d_ff, d_model)}
    return nn.ParameterDict({
        n: nn.Parameter(init_dense(gen, shapes[n][0], shapes[n][1:],
                                   device=device).to(dtype),
                        requires_grad=False)
        for n in mlp_names(kind)})


def embed(table: torch.Tensor, ids: torch.Tensor, scale: bool = False) -> torch.Tensor:
    """Rows of the float32 table, times sqrt(d_model) when ``scale``
    (before any cast to the working type, as the reference does)."""
    if isinstance(table, DTensor):
        return act_sharding.embed(table, ids, scale)
    y = table[ids]
    if scale:
        y = y * math.sqrt(table.shape[-1])
    return y


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x @ table.T`` in x's type: (..., E) -> (..., V)."""
    if isinstance(x, DTensor):
        return act_sharding.unembed(table, x)
    return x @ table.to(x.dtype).T
