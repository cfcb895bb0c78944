"""Per-layer residual blocks: the port of ``repro/models/blocks.py`` for the
``attn`` and ``attn_local`` kinds (pre-norms ``ln1``/``ln2`` and, where the
config asks, the post-norms ``pn1``/``pn2``).  The other kinds raise until
they are ported."""
from __future__ import annotations

import torch
from torch import nn

from . import config as C
from .attention import Attention, init_kv_cache
from .layers import init_dense, init_norm, mlp, mlp_names, norm


def not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"block kind {kind!r} is not ported yet (ROADMAP queue 1, item 15)")


class Block(nn.Module):
    """``x + pn1(attn(ln1 x))``, then ``x + pn2(mlp(ln2 x))``."""

    def __init__(self, cfg, kind: str, gen: torch.Generator, device):
        super().__init__()
        if kind not in (C.ATTN, C.ATTN_LOCAL):
            raise not_ported(kind)
        self.cfg, self.kind = cfg, kind
        e, ff, nk = cfg.d_model, cfg.d_ff, cfg.norm_kind
        dt = getattr(torch, cfg.dtype)
        self.ln1 = init_norm(e, device, nk)
        self.attn = Attention(cfg, kind, gen, device)
        self.ln2 = init_norm(e, device, nk)
        shapes = {"wi": (e, ff), "wg": (e, ff), "wo": (ff, e)}
        self.mlp = nn.ParameterDict({
            n: nn.Parameter(init_dense(gen, shapes[n][0], shapes[n][1:],
                                       device=device).to(dt),
                            requires_grad=False)
            for n in mlp_names(cfg.mlp_kind)})
        if cfg.use_post_norm:
            self.pn1 = init_norm(e, device, nk)
            self.pn2 = init_norm(e, device, nk)

    def _post(self, name: str, y: torch.Tensor) -> torch.Tensor:
        if not self.cfg.use_post_norm:
            return y
        return norm(getattr(self, name), y, self.cfg.norm_kind)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = mlp(self.mlp, norm(self.ln2, x, cfg.norm_kind), cfg.mlp_kind)
        return x + self._post("pn2", h)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        h = self.attn(norm(self.ln1, x, self.cfg.norm_kind), positions)
        return self._mlp(x + self._post("pn1", h))

    def decode(self, cache: dict, x: torch.Tensor, t: int) -> torch.Tensor:
        """One-token step (the reference's ``block_decode``); updates
        ``cache`` in place.  x: (B, 1, E)."""
        h = self.attn.decode(cache, norm(self.ln1, x, self.cfg.norm_kind), t)
        return self._mlp(x + self._post("pn1", h))


def init_block_cache(cfg, kind, batch, max_len, dtype=torch.bfloat16, *,
                     device=None) -> dict:
    if kind in (C.ATTN, C.ATTN_LOCAL):
        return init_kv_cache(cfg, kind, batch, max_len, dtype, device=device)
    raise not_ported(kind)
