"""Per-layer residual blocks: the port of ``repro/models/blocks.py``.

``attn``, ``attn_local`` and ``moe``: ``x + pn1(attn(ln1 x))``, then ``x +
pn2(mlp(ln2 x))`` (the post-norms ``pn1``/``pn2`` where the config asks;
a ``moe`` block is global attention followed by the MoE layer in place
of the MLP).  ``ssd``: ``x + ssd(ln1 x)``, no MLP.  ``rglru``: ``x +
rec(ln1 x)``, then ``x + mlp(ln2 x)``.  Any other kind raises
``ValueError``, as the reference does."""
from __future__ import annotations

import torch

from . import config as C
from .attention import Attention, init_kv_cache
from .layers import ParamTree, init_mlp, init_norm, mlp, norm
from .moe import init_moe, moe_forward
from .rglru import init_rglru, init_rglru_cache, rglru_decode, rglru_forward
from .ssm import init_ssd, init_ssd_cache, ssd_decode, ssd_forward

KINDS = (C.ATTN, C.ATTN_LOCAL, C.MOE, C.SSD, C.RGLRU)
RECURRENT = (C.SSD, C.RGLRU)


class Block(ParamTree):
    """One layer of kind ``kind``, its entries the reference's block tree.
    ``forward`` (serving) keeps a ``moe`` block's last call's stats in
    ``moe_stats``: ``aux_loss`` and ``dropped``, on the device.
    ``forward_aux`` (training) returns the aux loss as a value instead,
    so a recomputed forward (remat) writes nothing twice."""

    def __init__(self, cfg, kind: str, gen: torch.Generator, device):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(kind)
        self.cfg, self.kind = cfg, kind
        e, nk = cfg.d_model, cfg.norm_kind
        self.ln1 = init_norm(e, device, nk)
        if kind == C.SSD:
            self.ssd = init_ssd(cfg, gen, device)
            return
        if kind == C.RGLRU:
            self.rec = init_rglru(cfg, gen, device)
        else:
            self.attn = Attention(cfg, C.ATTN if kind == C.MOE else kind, gen,
                                  device)
        self.ln2 = init_norm(e, device, nk)
        if kind == C.MOE:
            self.moe = init_moe(cfg, gen, device)
            self.moe_stats: dict = {}
        else:
            self.mlp = init_mlp(gen, e, cfg.d_ff, cfg.mlp_kind,
                                getattr(torch, cfg.dtype), device)
        # the reference's recurrent blocks have no post-norms
        self.post = cfg.use_post_norm and kind != C.RGLRU
        if self.post:
            self.pn1 = init_norm(e, device, nk)
            self.pn2 = init_norm(e, device, nk)

    def _post(self, name: str, y: torch.Tensor) -> torch.Tensor:
        if not self.post:
            return y
        return norm(getattr(self, name), y, self.cfg.norm_kind)

    def _mlp(self, x: torch.Tensor):
        """``x + pn2(mlp(ln2 x))`` and the MoE stats (None for an MLP)."""
        cfg = self.cfg
        h = norm(self.ln2, x, cfg.norm_kind)
        stats = None
        if self.kind == C.MOE:
            h, stats = moe_forward(self.moe, cfg, h)
        else:
            h = mlp(self.mlp, h, cfg.mlp_kind)
        return x + self._post("pn2", h), stats

    def _forward(self, x, positions, kv_prefix, collect_kv):
        """(x', the attention's (k, v) or None, the MoE stats or None)."""
        cfg = self.cfg
        h = norm(self.ln1, x, cfg.norm_kind)
        if self.kind in RECURRENT:
            if kv_prefix is not None or collect_kv:
                raise ValueError(f"a {self.kind} block has no K/V to take "
                                 "or collect (the prefix cache serves "
                                 "homogeneous global-attention stacks)")
            if self.kind == C.SSD:
                return x + ssd_forward(cfg, self.ssd, h), None, None
            x, _ = self._mlp(x + rglru_forward(cfg, self.rec, h))
            return x, None, None
        h = self.attn(h, positions, kv_prefix=kv_prefix, collect_kv=collect_kv)
        kv = None
        if collect_kv:
            h, kv = h
        x, stats = self._mlp(x + self._post("pn1", h))
        return x, kv, stats

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                kv_prefix=None, collect_kv: bool = False):
        """x: (B, S, E) -> (B, S, E); with ``collect_kv`` also the
        attention's ``(k, v)`` (``Attention.forward`` for both
        arguments; a recurrent block has no K/V and raises)."""
        x, kv, stats = self._forward(x, positions, kv_prefix, collect_kv)
        if stats is not None:
            self.moe_stats = stats
        return (x, kv) if collect_kv else x

    def forward_aux(self, x: torch.Tensor, positions: torch.Tensor):
        """``(x', aux)``: the block and its float32 load-balance loss (0
        but for ``moe``), both in the graph."""
        x, _kv, stats = self._forward(x, positions, None, False)
        if stats is None:
            return x, torch.zeros((), dtype=torch.float32, device=x.device)
        return x, stats["aux_loss"]

    def decode(self, cache: dict, x: torch.Tensor, t: int) -> torch.Tensor:
        """One-token step (the reference's ``block_decode``); updates
        ``cache`` in place (a recurrent block's entries are replaced by
        the new state).  x: (B, 1, E)."""
        cfg = self.cfg
        h = norm(self.ln1, x, cfg.norm_kind)
        if self.kind in RECURRENT:
            step = ssd_decode if self.kind == C.SSD else rglru_decode
            params = self.ssd if self.kind == C.SSD else self.rec
            h, new = step(cfg, params, cache, h, t)
            cache.update(new)
            x = x + h
            return x if self.kind == C.SSD else self._mlp(x)[0]
        h = self.attn.decode(cache, h, t)
        x, stats = self._mlp(x + self._post("pn1", h))
        if stats is not None:
            self.moe_stats = stats
        return x


def init_block_cache(cfg, kind, batch, max_len, dtype=torch.bfloat16, *,
                     device=None) -> dict:
    """A layer's decode cache: the ring buffer of an attention kind, the
    recurrent state and conv history of ``ssd``/``rglru``."""
    if kind in (C.ATTN, C.ATTN_LOCAL, C.MOE):
        return init_kv_cache(cfg, kind, batch, max_len, dtype, device=device)
    if kind == C.SSD:
        return init_ssd_cache(cfg, batch, dtype, device=device)
    if kind == C.RGLRU:
        return init_rglru_cache(cfg, batch, dtype, device=device)
    raise ValueError(kind)
