"""Batched serving engine: DHT prefix cache -> suffix prefill -> decode
(the port of ``repro/serving/engine.py``).

Flow per batch of equal-length prompts (rectangular batching):

  1. chain-hash prompt blocks, DHT lookup -> longest fully cached block run
  2. fetch those pages from the pool (no prefill compute for them)
  3. prefill only the suffix, attending over the fetched prefix KV
  4. publish the new blocks' KV (pages + DHT pointers) for later requests
  5. seed the decode cache with [prefix, suffix] KV and decode greedily

Decode is eager, one ``decode_step`` a token.  On the card each token is
copied to pinned memory behind an event recorded before the next step is
launched, so the host reads token i while step i+1 runs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.layout import resolve_device
from ..models import decode_step, greedy_sample, init_cache
from ..models.model import LM
from .prefill import prefill_collect
from .prefix_cache import PrefixCache, check_fits


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, max_new)
    prefill_tokens_computed: int
    prefill_tokens_cached: int
    cache_stats: dict
    logits_last: torch.Tensor   # (B, V_pad) that seeded decode, on the device


class Engine:
    """Serves ``lm`` (built on ``device``: the card unless the caller
    names another) with a prefix cache of ``pool_pages`` pages of
    ``page_size`` tokens.  Token prompts only: a config with a modality
    frontend raises (F13), and a stack that is not homogeneous global
    attention raises at its first prefill (``prefill._check``)."""

    def __init__(self, model_cfg, lm: LM, *, max_len=4096, page_size=64,
                 pool_pages=512, dtype=torch.bfloat16, device=None):
        if model_cfg.frontend:
            # the reference's engine builds no ``frontend_embeds`` and
            # fails in ``_embed_inputs`` with a KeyError
            raise ValueError(
                f"{model_cfg.name} has a {model_cfg.frontend} frontend: the "
                "engine serves token prompts only (F13 in ROADMAP.md)")
        self.device = resolve_device(device)
        lm_dev = lm.embed.device
        if lm_dev.type != self.device.type:
            raise ValueError(f"the model is on {lm_dev}, the engine on "
                             f"{self.device}")
        self.cfg = model_cfg
        self.lm = lm
        self.max_len = max_len
        self.page_size = page_size
        self.dtype = dtype
        self.prefix_cache = PrefixCache(
            model_cfg, n_pages=pool_pages, page_size=page_size, dtype=dtype,
            device=self.device)

    def _seed_cache(self, batch_size, prompt_len, pk, pv, ks, vs) -> list:
        """The decode cache with [prefix, suffix] KV in place: each layer's
        ring buffer gets its rows and its own ``slot_pos``.  pk/ks: (L, B,
        S, Hk, D) or None."""
        cache = init_cache(self.cfg, batch_size, self.max_len, self.dtype,
                           device=self.device)
        p = 0 if pk is None else pk.shape[2]
        slot = torch.arange(prompt_len, dtype=torch.int32, device=self.device)
        for i, layer in enumerate(cache):
            if pk is not None:
                layer["k"][:, :p] = pk[i]
                layer["v"][:, :p] = pv[i]
            if ks is not None:
                layer["k"][:, p:prompt_len] = ks[i]
                layer["v"][:, p:prompt_len] = vs[i]
            layer["slot_pos"][:prompt_len] = slot
        return cache

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, max_new_tokens: int) -> GenerationResult:
        prompts = np.asarray(prompts, np.int32)
        b, s = prompts.shape
        if s % self.page_size:
            raise ValueError("prompts must be padded to page multiples")
        if s + max_new_tokens > self.max_len:
            raise ValueError(f"{s} + {max_new_tokens} tokens exceed max_len "
                             f"{self.max_len}")
        lm, cfg = self.lm, self.cfg

        n_pref, page_ids = self.prefix_cache.lookup(prompts)
        p_tok = n_pref * self.page_size
        # before any prefill: the suffix's blocks must fit the pool (F12)
        check_fits(len(self.prefix_cache.pool.gen), b,
                   s // self.page_size - n_pref)
        prefix = self.prefix_cache.fetch_prefix(page_ids) if n_pref else None

        suffix = prompts[:, p_tok:]
        if suffix.shape[1] > 0:
            batch = {"tokens": torch.from_numpy(suffix).to(self.device)}
            logits_last, ks, vs = prefill_collect(lm, cfg, batch,
                                                  kv_prefix=prefix)
            self.prefix_cache.publish(prompts, n_pref, ks, vs)
            pk, pv = (prefix[0], prefix[1]) if prefix is not None else (None, None)
            cache = self._seed_cache(b, s, pk, pv, ks, vs)
        else:
            # full-prefix hit: no prefill compute.  Seed the cache from the
            # pages and recover the last position's logits with one decode
            # step on the final prompt token (its KV rewrite is idempotent)
            cache = self._seed_cache(b, s, prefix[0], prefix[1], None, None)
            last = torch.from_numpy(prompts[:, -1:]).to(self.device)
            logits_last, cache = decode_step(lm, cache, last, s - 1)

        out = np.zeros((b, max_new_tokens), np.int32)
        tok = greedy_sample(logits_last, cfg)[:, None]
        on_card = self.device.type == "cuda"
        if on_card:
            host = torch.empty((max_new_tokens, b), dtype=torch.int32,
                               pin_memory=True)
        for i in range(max_new_tokens):
            if on_card:
                host[i].copy_(tok[:, 0], non_blocking=True)
                ready = torch.cuda.Event()
                ready.record()
            cur = tok
            if i + 1 < max_new_tokens:   # the last token's successor is unused
                logits, cache = decode_step(lm, cache, tok, s + i)
                tok = greedy_sample(logits, cfg)[:, None]
            if on_card:
                ready.synchronize()      # token i, not the step launched above
                out[:, i] = host[i].numpy()
            else:
                out[:, i] = cur[:, 0].numpy()
        return GenerationResult(
            tokens=out,
            prefill_tokens_computed=int(suffix.shape[1]) * b,
            prefill_tokens_cached=p_tok * b,
            cache_stats=dict(self.prefix_cache.stats),
            logits_last=logits_last,
        )
