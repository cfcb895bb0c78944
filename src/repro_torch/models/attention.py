"""Grouped-query attention with RoPE, local windows and QK-norm, and a
ring-buffer KV cache for decode: the port of ``repro/models/attention.py``.

Every ``attn_local`` layer's full-sequence attention is the local-attention
kernel (``kernels/ops.local_attention``: the hand-written CUDA kernel on
the card, its plain version on the CPU).  ``attn`` layers attend directly
up to ``DIRECT_ATTN_MAX_SEQ`` positions and through ``chunked_attention``
above, in plain torch, as in the reference.  Decode attends over the ring
buffer in plain torch; the cache is updated in place.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..kernels import ops
from . import config as C
from .flash import _mask_tile, chunked_attention
from .layers import apply_rope, dense, init_dense, init_norm, norm

DIRECT_ATTN_MAX_SEQ = 2048  # above this, use the chunked flash path


def _theta(cfg, kind):
    if kind == C.ATTN_LOCAL and cfg.rope_theta_local is not None:
        return cfg.rope_theta_local
    return cfg.rope_theta


def _attend(cfg, q, k, v, mask):
    """q: (B,S,H,D); k,v: (B,L,Hk,D); mask: (B or 1, S, L) -> (B,S,H*D)."""
    b, s, h, d = q.shape
    hk = k.shape[2]
    g = h // hk
    q5 = q.reshape(b, s, hk, g, d)
    scores = torch.einsum("bskgd,blkd->bkgsl", q5, k) / math.sqrt(d)
    scores = scores.to(torch.float32)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        scores = torch.tanh(scores / c) * c
    scores = scores + mask[:, None, None, :, :]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgsl,blkd->bskgd", probs, v)
    return out.reshape(b, s, h * d)


class Attention(nn.Module):
    """One layer's attention: projections ``wq`` (E, H, D), ``wk``/``wv``
    (E, Hk, D), ``wo`` (H*D, E) in the working type, optional biases
    ``bq``/``bk``/``bv`` and float32 ``q_norm``/``k_norm`` scales."""

    def __init__(self, cfg, kind: str, gen: torch.Generator, device):
        super().__init__()
        if kind not in (C.ATTN, C.ATTN_LOCAL):
            raise ValueError(kind)
        self.cfg, self.kind = cfg, kind
        e, h, hk, d = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dt = getattr(torch, cfg.dtype)

        def param(t):
            return nn.Parameter(t.to(dt), requires_grad=False)

        self.wq = param(init_dense(gen, e, (h, d), device=device))
        self.wk = param(init_dense(gen, e, (hk, d), device=device))
        self.wv = param(init_dense(gen, e, (hk, d), device=device))
        self.wo = param(init_dense(gen, h * d, (e,), scale=1.0 / math.sqrt(h * d),
                                   device=device))
        if cfg.qkv_bias:
            self.bq = param(torch.zeros(h, d, device=device))
            self.bk = param(torch.zeros(hk, d, device=device))
            self.bv = param(torch.zeros(hk, d, device=device))
        else:
            self.bq = self.bk = self.bv = None
        if cfg.qk_norm:
            self.q_norm = init_norm(d, device)
            self.k_norm = init_norm(d, device)

    def _qkv(self, x, positions):
        q = dense(self.wq, x, self.bq)
        k = dense(self.wk, x, self.bk)
        v = dense(self.wv, x, self.bv)
        if self.cfg.qk_norm:
            q = norm(self.q_norm, q)
            k = norm(self.k_norm, k)
        theta = _theta(self.cfg, self.kind)
        return apply_rope(q, positions, theta), apply_rope(k, positions, theta), v

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                kv_prefix=None, collect_kv: bool = False) -> torch.Tensor:
        """Full-sequence attention (prefill).  x: (B, S, E); positions:
        (B, S), each row ``0..S-1`` as ``model.forward`` gives them (the
        local kernel masks by row index)."""
        if kv_prefix is not None or collect_kv:
            raise NotImplementedError(
                "kv_prefix/collect_kv belong to the prefix-cache serving "
                "slice (ROADMAP queue 1, item 15)")
        cfg = self.cfg
        q, k, v = self._qkv(x, positions)
        b, s, h, d = q.shape
        if self.kind == C.ATTN_LOCAL:
            if not cfg.causal or cfg.logit_softcap:
                raise NotImplementedError(
                    "local attention is ported for causal layers without a "
                    "logit softcap (ROADMAP queue 1, item 15)")
            out = ops.local_attention(q, k, v, window=cfg.local_window)
            out = out.reshape(b, s, h * d)
        elif s > DIRECT_ATTN_MAX_SEQ:
            out = chunked_attention(q, k, v, positions, positions,
                                    causal=cfg.causal, softcap=cfg.logit_softcap)
        else:
            mask = _mask_tile(positions, positions, cfg.causal, None)
            out = _attend(cfg, q, k, v, mask)
        return out @ self.wo.to(x.dtype)

    def decode(self, cache: dict, x: torch.Tensor, t: int) -> torch.Tensor:
        """One-token decode at absolute position ``t``.  x: (B, 1, E).
        Writes this token's K/V into slot ``t % length`` of ``cache`` in
        place and returns (B, 1, E)."""
        pos = torch.full((x.shape[0], 1), t, dtype=torch.int32, device=x.device)
        q, k, v = self._qkv(x, pos)
        length = cache["k"].shape[1]
        idx = t % length
        cache["k"][:, idx] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, idx] = v[:, 0].to(cache["v"].dtype)
        cache["slot_pos"][idx] = t
        window = self.cfg.local_window if self.kind == C.ATTN_LOCAL else None
        mask = _mask_tile(pos, cache["slot_pos"][None, :], True, window)
        out = _attend(self.cfg, q, cache["k"], cache["v"], mask)
        return out @ self.wo.to(x.dtype)


def init_kv_cache(cfg, kind, batch, max_len, dtype=torch.bfloat16, *,
                  device=None) -> dict:
    """Ring buffer of one layer: local layers keep only their window;
    ``slot_pos`` (absolute position per slot, -1 = empty) is shared by
    the batch."""
    length = min(cfg.local_window, max_len) if kind == C.ATTN_LOCAL else max_len
    hk, d = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, length, hk, d), dtype=dtype, device=device),
        "v": torch.zeros((batch, length, hk, d), dtype=dtype, device=device),
        "slot_pos": torch.full((length,), -1, dtype=torch.int32, device=device),
    }
