"""Chunked (flash-style) attention in plain torch: the port of
``repro/models/flash.py``.  Online softmax over KV chunks, a Python loop
over query chunks; the (S, L) score matrix is never built.  Global
layers above ``DIRECT_ATTN_MAX_SEQ`` take it.  With a window shorter
than the keys it takes the banded branch, which touches only the KV band
each query chunk can see.

The reference's numerics are kept: the probabilities are cast to V's
type before the product with V, and the accumulator stays in the query
type (bfloat16 on the card's bf16 path).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _mask_tile(q_pos, k_pos, causal, window):
    """(…,Sq) x (…,Ck) -> additive f32 mask tile (…, Sq, Ck) from absolute
    positions; key positions < 0 (padding, empty cache slots) are masked."""
    valid = k_pos[..., None, :] >= 0
    if causal:
        valid = valid & (k_pos[..., None, :] <= q_pos[..., :, None])
    if window is not None:
        valid = valid & ((q_pos[..., :, None] - k_pos[..., None, :]) < window)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(valid, zero, NEG_INF)


def _tile_scores(qc, kc, softcap):
    """qc: (B,Cq,Hk,G,D), kc: (B,Ck,Hk,D) -> (B,Hk,G,Cq,Ck) f32."""
    d = qc.shape[-1]
    s = torch.einsum("bqkgd,bckd->bkgqc", qc, kc) / math.sqrt(d)
    s = s.to(torch.float32)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    return s


def _online_update(carry, s, vc):
    """Standard streaming-softmax accumulator update."""
    m, lse, acc = carry
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = lse * alpha + p.sum(dim=-1)
    pv = torch.einsum("bkgqc,bckd->bkgqd", p.to(vc.dtype), vc)
    acc_new = acc * alpha[..., None].to(acc.dtype) + pv
    return m_new, l_new, acc_new


def chunked_attention(
    q: torch.Tensor,        # (B, S, H, D)
    k: torch.Tensor,        # (B, L, Hk, D)
    v: torch.Tensor,        # (B, L, Hk, D)
    q_pos: torch.Tensor,    # (B, S) absolute positions
    k_pos: torch.Tensor,    # (B, L)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Returns (B, S, H*D)."""
    b, s, h, d = q.shape
    lk, hk = k.shape[1], k.shape[2]
    g = h // hk
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, lk)
    s_orig = s
    # pad to chunk multiples; padded KV rows get position -1 (masked out)
    if s % q_chunk:
        pq = q_chunk - s % q_chunk
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
        q_pos = F.pad(q_pos, (0, pq))
        s += pq
    if lk % kv_chunk:
        pk = kv_chunk - lk % kv_chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
        k_pos = F.pad(k_pos, (0, pk), value=-1)
        lk += pk
    nq, nk = s // q_chunk, lk // kv_chunk

    banded = window is not None and window < lk
    if banded:
        # only the KV band [q_end - tile_len, q_end) can be visible; the
        # band is at most all of the keys
        tile_len = min(-(-(window + q_chunk) // kv_chunk) * kv_chunk, lk)

    outs = []
    for qi in range(nq):
        qc = q[:, qi * q_chunk:(qi + 1) * q_chunk].reshape(b, q_chunk, hk, g, d)
        qpc = q_pos[:, qi * q_chunk:(qi + 1) * q_chunk]
        carry = (
            torch.full((b, hk, g, q_chunk), NEG_INF, dtype=torch.float32,
                       device=q.device),
            torch.zeros((b, hk, g, q_chunk), dtype=torch.float32, device=q.device),
            torch.zeros((b, hk, g, q_chunk, d), dtype=q.dtype, device=q.device),
        )
        if banded:
            q_end = (qi + 1) * q_chunk
            start = min(max(q_end - tile_len, 0), lk - tile_len)
            spans = [(start, start + tile_len)]
        else:
            spans = [(j * kv_chunk, (j + 1) * kv_chunk) for j in range(nk)]
        for lo, hi in spans:
            sc = _tile_scores(qc, k[:, lo:hi], softcap)
            sc = sc + _mask_tile(qpc, k_pos[:, lo:hi], causal, window)[:, None, None]
            carry = _online_update(carry, sc, v[:, lo:hi])
        _m, lq, accq = carry
        out = accq / torch.clamp(lq, min=1e-30)[..., None].to(accq.dtype)
        # (B,Hk,G,Cq,D) -> (B,Cq,H*D)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, q_chunk, h * d))
    # dropping query padding
    return torch.cat(outs, dim=1)[:, :s_orig]
