"""Per-layer residual blocks: the port of ``repro/models/blocks.py`` for the
``attn``, ``attn_local`` and ``moe`` kinds (pre-norms ``ln1``/``ln2`` and,
where the config asks, the post-norms ``pn1``/``pn2``).  A ``moe`` block
is global attention followed by the MoE layer in place of the MLP.  The
other kinds raise until they are ported."""
from __future__ import annotations

import torch
from torch import nn

from . import config as C
from .attention import Attention, init_kv_cache
from .layers import init_mlp, init_norm, mlp, norm
from .moe import init_moe, moe_forward


def not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"block kind {kind!r} is not ported yet (ROADMAP queue 1, item 15)")


class Block(nn.Module):
    """``x + pn1(attn(ln1 x))``, then ``x + pn2(mlp(ln2 x))`` (the MoE
    layer in a ``moe`` block, whose last call's stats stay in
    ``moe_stats``: ``aux_loss`` and ``dropped``, on the device)."""

    def __init__(self, cfg, kind: str, gen: torch.Generator, device):
        super().__init__()
        if kind not in (C.ATTN, C.ATTN_LOCAL, C.MOE):
            raise not_ported(kind)
        self.cfg, self.kind = cfg, kind
        e, nk = cfg.d_model, cfg.norm_kind
        self.ln1 = init_norm(e, device, nk)
        self.attn = Attention(cfg, C.ATTN if kind == C.MOE else kind, gen,
                              device)
        self.ln2 = init_norm(e, device, nk)
        if kind == C.MOE:
            self.moe = init_moe(cfg, gen, device)
            self.moe_stats: dict = {}
        else:
            self.mlp = init_mlp(gen, e, cfg.d_ff, cfg.mlp_kind,
                                getattr(torch, cfg.dtype), device)
        if cfg.use_post_norm:
            self.pn1 = init_norm(e, device, nk)
            self.pn2 = init_norm(e, device, nk)

    def _post(self, name: str, y: torch.Tensor) -> torch.Tensor:
        if not self.cfg.use_post_norm:
            return y
        return norm(getattr(self, name), y, self.cfg.norm_kind)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = norm(self.ln2, x, cfg.norm_kind)
        if self.kind == C.MOE:
            h, self.moe_stats = moe_forward(self.moe, cfg, h)
        else:
            h = mlp(self.mlp, h, cfg.mlp_kind)
        return x + self._post("pn2", h)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                kv_prefix=None, collect_kv: bool = False):
        """x: (B, S, E) -> (B, S, E); with ``collect_kv`` also the
        attention's ``(k, v)`` (``Attention.forward`` for both
        arguments)."""
        h = self.attn(norm(self.ln1, x, self.cfg.norm_kind), positions,
                      kv_prefix=kv_prefix, collect_kv=collect_kv)
        if collect_kv:
            h, kv = h
            return self._mlp(x + self._post("pn1", h)), kv
        return self._mlp(x + self._post("pn1", h))

    def decode(self, cache: dict, x: torch.Tensor, t: int) -> torch.Tensor:
        """One-token step (the reference's ``block_decode``); updates
        ``cache`` in place.  x: (B, 1, E)."""
        h = self.attn.decode(cache, norm(self.ln1, x, self.cfg.norm_kind), t)
        return self._mlp(x + self._post("pn1", h))


def init_block_cache(cfg, kind, batch, max_len, dtype=torch.bfloat16, *,
                     device=None) -> dict:
    if kind in (C.ATTN, C.ATTN_LOCAL, C.MOE):
        return init_kv_cache(cfg, kind, batch, max_len, dtype, device=device)
    raise not_ported(kind)
