"""Language-model assembly: embeddings -> layer stack -> head, the train
loss, prefill and the decode step.  The port of ``repro/models/model.py``
for every block kind and the modality-frontend stubs: a config with a
``frontend`` (internvl2's patches, hubert's frames) takes precomputed
embeddings in ``batch["frontend_embeds"]`` as a prefix of the sequence.

Serving (``forward``, ``prefill``, ``decode_step``) builds no graph.
``loss_fn`` does: it is the training forward, with the aux loss of MoE
blocks summed through the stack and remat per period group, and the tied
head unembedding through the table itself (``embed`` cast in the graph),
so the table's gradient has both of its uses, as the reference's has.

Weights: every matrix is stored once in the working type ``cfg.dtype``
(the reference keeps float32 and casts at every use: the same numbers);
norm scales stay float32; the embedding table stays float32 because the
reference scales the looked-up rows before the cast.  A tied head is a
working-type copy of the table made once (a buffer, not a parameter); an
untied head (``tie_embeddings=False``) is a parameter of its own in the
working type, the reference's ``params["head"]["table"]``.  Parameters
are random, drawn from the caller's ``torch.Generator``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from ..core.layout import resolve_device
from . import act_sharding
from .config import ModelConfig
from .layers import embed, init_norm, norm, unembed
from .stack import Stack, init_stack_cache

IGNORE = -1  # label id for masked-out positions (e.g. frontend prefix)
AUX_WEIGHT = 0.01  # the MoE aux loss's weight in the train loss

def _table(cfg: ModelConfig, gen: torch.Generator, device) -> torch.Tensor:
    """A float32 ``(V_pad, E)`` table of normals times 0.02 (the
    reference's ``init_embedding``)."""
    return torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen,
                       dtype=torch.float32, device=device).mul_(0.02)


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(_table(cfg, gen, device), requires_grad=False)
        self.stack = Stack(cfg, gen, device)
        self.final_norm = init_norm(cfg.d_model, device, cfg.norm_kind)
        if cfg.tie_embeddings:
            self.register_buffer("head", None, persistent=False)
            self.refresh_head()
        else:
            self.head = nn.Parameter(_table(cfg, gen, device).to(self.dtype),
                                     requires_grad=False)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    def refresh_head(self) -> None:
        """The tied head: the embedding table in the working type (call
        again after the table changes).  An untied head is left as it
        is."""
        if self.cfg.tie_embeddings:
            self.head = self.embed.detach().to(self.dtype)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return unembed(self.head, norm(self.final_norm, x, self.cfg.norm_kind))


def init_lm(cfg: ModelConfig, *, generator: torch.Generator,
            device: str | torch.device | None = None) -> LM:
    """A model with random parameters from ``generator`` (which must live
    on ``device``), on the card unless ``device`` names another."""
    dev = resolve_device(device)
    with torch.no_grad():
        return LM(cfg, generator, dev)


def _embed_inputs(lm: LM, batch) -> torch.Tensor:
    """Token embeddings, scaled by sqrt(d_model) in float32 when the
    config asks, then cast to the working type; with a frontend,
    ``batch["frontend_embeds"]`` (B, F, E) first, cast to the working
    type and then scaled under ``emb_scale``.  hubert's ``frontend_len =
    -1`` means every position is a frame: its ``tokens`` are (B, 0)."""
    cfg = lm.cfg
    x = embed(lm.embed, batch["tokens"], scale=cfg.emb_scale).to(lm.dtype)
    if cfg.frontend:
        fe = batch["frontend_embeds"].to(lm.dtype)
        if cfg.emb_scale:
            fe = fe * math.sqrt(cfg.d_model)
        x = torch.cat([fe, x], dim=1)
    return x


@torch.no_grad()
def forward(lm: LM, batch) -> torch.Tensor:
    """batch["tokens"]: (B, S) int (and ``frontend_embeds`` (B, F, E)
    with a frontend) -> logits (B, F + S, V_pad)."""
    x = _embed_inputs(lm, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    return lm.logits(lm.stack(x, positions))


@torch.no_grad()
def prefill(lm: LM, batch) -> torch.Tensor:
    """Logits (B, V_pad) of the last prompt position, to seed decode.  As
    in the reference, no cache is filled (serving fills it through the
    prefix cache).  Only the last position goes through the head: the
    head and the final norm act per position, so the numbers are
    ``forward(...)[:, -1]``."""
    x = _embed_inputs(lm, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    return lm.logits(lm.stack(x, positions)[:, -1])


def loss_fn(lm: LM, batch, *, n_valid=None):
    """Next-token (decoder) or frame-label (encoder) cross entropy, in a
    graph.  ``batch["labels"]``: (B, F + S) int with ``IGNORE`` for masked
    positions.  Returns ``(loss + AUX_WEIGHT * aux, {"loss", "aux_loss",
    "tokens"})``, tensors on the device.

    The mean is over the valid labels of this batch, as the reference's;
    ``n_valid`` replaces that count (a data-parallel step passes the
    global batch's count over the group's size, so the ranks' mean loss
    is the global one)."""
    cfg = lm.cfg
    x = _embed_inputs(lm, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    x, aux = lm.stack.forward_aux(x, positions)
    x = norm(lm.final_norm, x, cfg.norm_kind)
    logits = unembed(lm.embed if cfg.tie_embeddings else lm.head, x)
    if isinstance(logits, DTensor):
        logits = act_sharding.reduce_partial(logits)
    logits = logits.to(torch.float32)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    labels = batch["labels"].to(x.device)
    valid = labels != IGNORE
    safe = torch.clamp(labels, min=0).to(torch.int64)
    # log_softmax then the label's entry, as one call: its backward writes
    # the gradient in place, where gather's would scatter into zeros of the
    # whole (B, S, V) (of its global shape on DTensor logits)
    nll = F.cross_entropy(logits.flatten(0, 1), safe.flatten(0, 1),
                          reduction="none").reshape(safe.shape)
    n = torch.clamp(valid.sum(), min=1) if n_valid is None else n_valid
    loss = torch.where(valid, nll, 0.0).sum() / n
    metrics = {"loss": loss.detach(), "aux_loss": aux.detach(), "tokens": n}
    return loss + AUX_WEIGHT * aux, metrics


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device=None) -> list:
    if not cfg.has_decode:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    return init_stack_cache(cfg, batch, max_len, dtype,
                            device=resolve_device(device))


@torch.no_grad()
def decode_step(lm: LM, cache: list, tokens: torch.Tensor, t: int):
    """One decode step.  tokens: (B, 1) int; t: absolute position.
    Returns (logits (B, V_pad), cache), the cache updated in place."""
    x = embed(lm.embed, tokens, scale=lm.cfg.emb_scale).to(lm.dtype)
    x = lm.stack.decode(cache, x, int(t))
    return lm.logits(x)[:, 0], cache


def greedy_sample(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """argmax over the real vocabulary (the padded tail is masked)."""
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -math.inf)
    if isinstance(logits, DTensor):
        return act_sharding.argmax(logits).to(torch.int32)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def param_count(lm: LM) -> int:
    """Parameters held: the reference's count (a tied head's copy is not
    one, an untied head is)."""
    return sum(p.numel() for p in lm.parameters())
