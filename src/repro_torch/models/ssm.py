"""Mamba-2 SSD (state-space duality) block: the port of
``repro/models/ssm.py`` (arXiv:2405.21060).

Prefill runs the chunked SSD algorithm: the quadratic term inside each
chunk, then the linear recurrence across chunks, which the reference
evaluates with ``lax.scan`` and the port with a Python loop over the
chunks (``_inter_chunk``: two elementwise ops a chunk).  Decode is the
O(1) recurrent update.  d_inner is split into heads of ``ssm_head_dim``;
B and C are shared across heads (one group).

The reference computes all of this outside Pallas, so its port is plain
torch: ``einsum``, ``matmul`` and elementwise ops.  Its casts are kept
where it makes them (x, B and C to float32 for the chunked part, ``dt``
through softplus in float32, ``y`` back to the input type before the
``silu(z)`` gate), so bf16 numbers take the same path.  The in/out
projections and the conv weight are stored in ``cfg.dtype`` (the
reference casts them at use: the same numbers); ``A_log``, ``D``,
``dt_bias`` and the norm scale stay float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ParamTree, causal_conv, init_dense, init_norm, norm, weight


def init_ssd(cfg, gen: torch.Generator, device=None) -> ParamTree:
    """The reference's ``init_ssd`` tree: ``in_proj.w`` (E, 2*di + 2*st +
    nh), ``conv.w`` (W, di + 2*st), ``A_log``, ``D``, ``dt_bias`` (nh,),
    ``norm.scale`` (di,) and ``out_proj.w`` (di, E)."""
    e, di, st, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dt = getattr(torch, cfg.dtype)

    def vec(t):
        return nn.Parameter(t, requires_grad=False)

    return ParamTree(
        # fused input projection: [z (di), x (di), B (st), C (st), dt (nh)]
        in_proj=weight(init_dense(gen, e, (2 * di + 2 * st + nh,),
                                  device=device), dt),
        conv=weight(init_dense(gen, cfg.ssm_conv, (di + 2 * st,), scale=0.1,
                               device=device), dt),
        A_log=vec(torch.zeros(nh, device=device)),   # A = -exp(A_log)
        D=vec(torch.ones(nh, device=device)),
        dt_bias=vec(torch.zeros(nh, device=device)),
        norm=init_norm(di, device),
        out_proj=weight(init_dense(gen, di, (e,), device=device), dt))


def _split_proj(cfg, zxbcdt):
    di, st = cfg.d_inner, cfg.ssm_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * st],
            zxbcdt[..., 2 * di + 2 * st:])


def _proj(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``einsum("bse,ef->bsf", x, w)`` in x's type."""
    return x @ w.to(x.dtype)


def _causal_conv(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time, then SiLU (the RG-LRU's conv has
    no activation)."""
    return F.silu(causal_conv(w, x))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{j<k<=i} a_k as the plain difference of
    cumulative sums, -inf above the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return out.masked_fill(~mask, -torch.inf)


def _inter_chunk(states: torch.Tensor, chunk_decay: torch.Tensor) -> torch.Tensor:
    """The linear recurrence across chunks: the state entering each chunk.
    states: (B, nc, nh, hd, st); chunk_decay: (B, nc, nh) -> (B, nc, nh,
    hd, st), chunk 0's state zero (the reference's ``lax.scan``)."""
    h = torch.zeros_like(states[:, 0])
    prev = []
    for c in range(states.shape[1]):
        prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    return torch.stack(prev, dim=1)


def ssd_forward(cfg, params, x_in: torch.Tensor, *, chunk=None) -> torch.Tensor:
    """Full-sequence SSD.  x_in: (B, S, E) -> (B, S, E)."""
    chunk = chunk or cfg.ssm_chunk
    b, s, _ = x_in.shape
    di, st, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc, dt = _split_proj(cfg, _proj(params["in_proj"]["w"], x_in))
    xbc = _causal_conv(params["conv"]["w"].to(x_in.dtype), xbc)
    x = xbc[..., :di].reshape(b, s, nh, hd)
    B = xbc[..., di:di + st]
    C = xbc[..., di + st:]
    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])     # (B,S,nh)
    A = -torch.exp(params["A_log"])                                  # (nh,)

    q = min(chunk, s)
    s_orig = s
    if s % q:   # pad the tail chunk; padded outputs are sliced away below
        pad = q - s % q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        B, C, dt, z = (F.pad(t, (0, 0, 0, pad)) for t in (B, C, dt, z))
        s += pad
    nc = s // q
    f32 = torch.float32
    xq = x.reshape(b, nc, q, nh, hd).to(f32)
    Bq = B.reshape(b, nc, q, st).to(f32)
    Cq = C.reshape(b, nc, q, st).to(f32)
    dtq = dt.reshape(b, nc, q, nh)
    dA = dtq * A                                                     # (B,nc,q,nh)

    # intra-chunk (quadratic within the chunk)
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))                   # (B,nc,nh,q,q)
    scores = torch.einsum("bcqn,bcsn->bcqs", Cq, Bq)
    xbar = xq * dtq[..., None]                                       # dt discretizes B
    y_diag = torch.einsum("bcqs,bchqs,bcshp->bcqhp", scores, L, xbar)

    # chunk summaries
    dA_cum = torch.cumsum(dA, dim=2)                                 # (B,nc,q,nh)
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)
    states = torch.einsum("bcsn,bcsh,bcshp->bchpn", Bq, decay_to_end * dtq, xq)

    # inter-chunk linear recurrence
    prev = _inter_chunk(states, torch.exp(dA_cum[:, :, -1, :]))
    y_off = torch.einsum("bcqn,bchpn,bcqh->bcqhp", Cq, prev, torch.exp(dA_cum))

    y = (y_diag + y_off).reshape(b, s, nh, hd)
    y = y + xq.reshape(b, s, nh, hd) * params["D"][None, None, :, None]
    y = y.reshape(b, s, di)[:, :s_orig].to(x_in.dtype)
    y = y * F.silu(z[:, :s_orig])
    y = norm(params["norm"], y)
    return _proj(params["out_proj"]["w"], y)


def init_ssd_cache(cfg, batch: int, dtype=torch.float32, *, device=None) -> dict:
    """``h`` (B, nh, hd, st) float32 and the conv history ``conv`` (B,
    W-1, di + 2*st) in ``dtype``."""
    return {
        "h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1,
                             cfg.d_inner + 2 * cfg.ssm_state),
                            dtype=dtype, device=device),
    }


def ssd_decode(cfg, params, cache: dict, x_in: torch.Tensor, t):
    """One-token recurrent update.  x_in: (B, 1, E) -> ``(out (B, 1, E),
    {"h", "conv"})``, the new cache (the reference's, as new tensors)."""
    b = x_in.shape[0]
    di, st, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc, dt = _split_proj(cfg, _proj(params["in_proj"]["w"], x_in))
    # causal conv over [cache, current]
    hist = torch.cat([cache["conv"].to(xbc.dtype), xbc], dim=1)      # (B, W, C)
    w = params["conv"]["w"].to(xbc.dtype)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", hist, w))[:, None, :]

    f32 = torch.float32
    x = conv_out[..., :di].reshape(b, nh, hd)
    B = conv_out[:, 0, di:di + st]
    C = conv_out[:, 0, di + st:]
    dt_ = F.softplus(dt[:, 0].to(f32) + params["dt_bias"])          # (B,nh)
    dA = torch.exp(dt_ * -torch.exp(params["A_log"]))
    h = cache["h"] * dA[..., None, None] + torch.einsum(
        "bn,bh,bhp->bhpn", B.to(f32), dt_, x.to(f32))
    y = torch.einsum("bn,bhpn->bhp", C.to(f32), h)
    y = y + x.to(f32) * params["D"][None, :, None]
    y = y.reshape(b, 1, di).to(x_in.dtype)
    y = y * F.silu(z)
    y = norm(params["norm"], y)
    return _proj(params["out_proj"]["w"], y), {"h": h, "conv": hist[:, 1:, :]}
