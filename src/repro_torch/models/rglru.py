"""RecurrentGemma / Griffin recurrent block (RG-LRU): the port of
``repro/models/rglru.py`` (arXiv:2402.19427).

Two branches from the input, merged by an elementwise product, then a
linear out projection:
  gate branch  : linear -> GeLU
  signal branch: linear -> causal conv1d -> RG-LRU

RG-LRU recurrence, per channel, in float32:
  r_t = sigmoid(W_a x_t),  i_t = sigmoid(W_x x_t)
  a_t = exp(-c * softplus(Lambda) * r_t)         (c = 8)
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill evaluates ``h_t = a_t h_{t-1} + b_t`` with a log-depth scan over
time (``_scan``): the odd/even recursion of ``jax.lax.associative_scan``,
about 2 log2(S) levels of elementwise passes, so the sums fall in the
reference's order.  The reference computes none of this in Pallas, so
plain torch is its port.  Decode is the O(1) step.  The matrices and the
conv weight are stored in ``cfg.dtype``; ``lam`` stays float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ParamTree, causal_conv, init_dense, weight

_C = 8.0


def init_rglru(cfg, gen: torch.Generator, device=None) -> ParamTree:
    """The reference's ``init_rglru`` tree: ``gate_in.w``, ``sig_in.w``
    (E, W), ``conv.w`` (conv_width, W), ``wa.w``, ``wx.w`` (W, W), ``lam``
    (W,) float32 and ``out.w`` (W, E)."""
    e = cfg.d_model
    w = cfg.lru_width or e
    dt = getattr(torch, cfg.dtype)
    return ParamTree(
        gate_in=weight(init_dense(gen, e, (w,), device=device), dt),
        sig_in=weight(init_dense(gen, e, (w,), device=device), dt),
        conv=weight(init_dense(gen, cfg.conv_width, (w,), scale=0.1,
                               device=device), dt),
        wa=weight(init_dense(gen, w, (w,), device=device), dt),
        wx=weight(init_dense(gen, w, (w,), device=device), dt),
        # softplus(1) ~ 1.31 decay scale
        lam=nn.Parameter(torch.ones(w, device=device), requires_grad=False),
        out=weight(init_dense(gen, w, (e,), device=device), dt))


def _gates(params, x: torch.Tensor):
    """(a, gated), float32: the decay and the gated input."""
    f32 = torch.float32
    r = torch.sigmoid(x @ params["wa"]["w"].to(x.dtype))
    i = torch.sigmoid(x @ params["wx"]["w"].to(x.dtype))
    log_a = -_C * F.softplus(params["lam"]) * r.to(f32)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (
        i.to(f32) * x.to(f32))
    return a, gated


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Rows of ``even`` at 0, 2, 4, ... and of ``odd`` at 1, 3, ... along
    the time axis (dim 1); ``even`` has as many rows or one more."""
    n = even.shape[1] + odd.shape[1]
    out = even.new_empty((even.shape[0], n) + tuple(even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of ``(a, b)`` pairs along dim 1 under ``(a1, b1) .
    (a2, b2) = (a1 a2, b2 + a2 b1)``: the recursion of
    ``jax.lax.associative_scan``.  Returns ``(A, h)``, h_t = a_t h_{t-1}
    + b_t from h_{-1} = 0."""
    n = a.shape[1]
    if n < 2:
        return a, b
    # combine adjacent pairs, scan the pairs, then fill in the even rows
    a1, b1, a2, b2 = a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2]
    odd_a, odd_b = _scan(a1 * a2, b2 + a2 * b1)
    la, lb = (odd_a[:, :-1], odd_b[:, :-1]) if n % 2 == 0 else (odd_a, odd_b)
    ra, rb = a[:, 2::2], b[:, 2::2]
    even_a = torch.cat([a[:, :1], la * ra], dim=1)
    even_b = torch.cat([b[:, :1], rb + ra * lb], dim=1)
    return _interleave(even_a, odd_a), _interleave(even_b, odd_b)


def rglru_forward(cfg, params, x_in: torch.Tensor) -> torch.Tensor:
    """x_in: (B, S, E) -> (B, S, E)."""
    dt = x_in.dtype
    gate = F.gelu(x_in @ params["gate_in"]["w"].to(dt), approximate="tanh")
    sig = x_in @ params["sig_in"]["w"].to(dt)
    sig = causal_conv(params["conv"]["w"].to(sig.dtype), sig)
    a, gated = _gates(params, sig)
    _, h = _scan(a, gated)
    h = h.to(dt) * gate
    return h @ params["out"]["w"].to(dt)


def init_rglru_cache(cfg, batch: int, dtype=torch.float32, *, device=None) -> dict:
    """``h`` (B, W) float32 and the conv history ``conv`` (B, width-1, W)
    in ``dtype``."""
    w = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                            device=device),
    }


def rglru_decode(cfg, params, cache: dict, x_in: torch.Tensor, t):
    """x_in: (B, 1, E) -> ``(out (B, 1, E), {"h", "conv"})``, the new cache
    (the reference's, as new tensors)."""
    dt = x_in.dtype
    gate = F.gelu(x_in @ params["gate_in"]["w"].to(dt), approximate="tanh")
    sig = x_in @ params["sig_in"]["w"].to(dt)
    hist = torch.cat([cache["conv"].to(sig.dtype), sig], dim=1)
    w = params["conv"]["w"].to(sig.dtype)
    sig1 = torch.einsum("bwc,wc->bc", hist, w)[:, None, :]
    a, gated = _gates(params, sig1)
    h = a[:, 0] * cache["h"] + gated[:, 0]
    out = h[:, None, :].to(dt) * gate
    return out @ params["out"]["w"].to(dt), {"h": h, "conv": hist[:, 1:, :]}
