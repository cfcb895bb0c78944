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


def dense(w: torch.Tensor, x: torch.Tensor,
          b: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ W (+ b)``, W: (in, *out), contracting the last axis of x."""
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


def embed(table: torch.Tensor, ids: torch.Tensor, scale: bool = False) -> torch.Tensor:
    """Rows of the float32 table, times sqrt(d_model) when ``scale``
    (before any cast to the working type, as the reference does)."""
    y = table[ids]
    if scale:
        y = y * math.sqrt(table.shape[-1])
    return y


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x @ table.T`` in x's type: (..., E) -> (..., V)."""
    return x @ table.to(x.dtype).T
