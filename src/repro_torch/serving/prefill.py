"""KV-collecting prefill for homogeneous-attention stacks (period 1:
llama3 / qwen1.5 / starcoder2 / llama4 / qwen3-moe): the port of
``repro/serving/prefill.py``.

Used by the prefix cache: prefill returns every layer's (K, V) so new
blocks can be published to the page pool, and accepts an already-cached
prefix (pk, pv, positions) so only the suffix is computed.
"""
from __future__ import annotations

import torch

from ..models import config as C
from ..models.model import LM, _embed_inputs
from ..models.stack import find_period


def _check(cfg) -> str:
    p, _, tail = find_period(cfg.block_pattern)
    kind = cfg.block_pattern[0]
    if not (p == 1 and tail == 0 and kind in (C.ATTN, C.MOE)):
        raise ValueError(
            f"prefix cache supports homogeneous global-attention stacks; "
            f"{cfg.name} has period {p} (see DESIGN.md §6)")
    return kind


@torch.no_grad()
def prefill_collect(lm: LM, cfg, batch, kv_prefix=None):
    """Returns ``(logits_last (B, V_pad), ks, vs)`` with ``ks``/``vs``
    ``(L, B, S, Hk, D)`` for the *suffix* tokens computed here, at
    positions offset by the prefix length.

    kv_prefix: optional ``(pk (L, B, P, Hk, D), pv, p_pos (B, P))``,
    cached pages; prefix rows at position -1 are masked out.  Only the
    last position goes through the final norm and the head.  A ``moe``
    layer routes the suffix's tokens alone, in the reference's capacity
    groups over them."""
    _check(cfg)
    x = _embed_inputs(lm, batch)
    b, s, _ = x.shape
    p_len = 0 if kv_prefix is None else kv_prefix[0].shape[2]
    positions = (torch.arange(s, dtype=torch.int32, device=x.device)
                 + p_len).expand(b, s)
    ks, vs = [], []
    for i, layer in enumerate(lm.stack.layers):
        prefix = None if kv_prefix is None else (
            kv_prefix[0][i], kv_prefix[1][i], kv_prefix[2])
        x, (k, v) = layer(x, positions, kv_prefix=prefix, collect_kv=True)
        ks.append(k)
        vs.append(v)
    return lm.logits(x[:, -1]), torch.stack(ks), torch.stack(vs)
