"""AdamW with decoupled weight decay, global-norm clipping and optional
gradient compression: the port of ``repro/optim/adamw.py``.

Parameters, gradients and the moments are mappings ``{name: tensor}``: a
model's ``named_parameters()`` (``train.train_step`` passes them) or any
dict of tensors.  The decay mask reads the **reference's** path of each
entry (``paths``: name -> ``"stack/scan/b0/attn/wq/b"``;
``convert.lm_param_paths`` gives a model's), and compares its keys whole,
as the reference does: a qkv bias's key is ``b``, not ``bias``, so it is
decayed; ``scale``, ``bias``, ``A_log``, ``D``, ``dt_bias`` and ``lam``
are not.  Without ``paths`` a name is its own path (``/``-separated).

The update runs in place on the parameters (under ``no_grad``) and on the
state.  A master copy (``master=True``) is kept for every parameter that
is not float32: the update runs on the float32 master and the working
parameter is its cast, the reference's ``master`` branch; a float32
parameter is its own master, so the numbers are those of a float32
parameter updated directly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"      # cosine | linear | const
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # gradient compression for the cross-replica reduce
    compression: str = "none"     # none | int8 | topk
    topk_ratio: float = 0.05


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor; float32 arithmetic)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + torch.cos(math.pi * t))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_ratio) * t
    else:
        decay = torch.ones_like(t)
    return cfg.lr * warm * decay


def init_opt_state(params: Mapping[str, torch.Tensor],
                   master: bool = False) -> dict:
    """``{"mu", "nu"}`` float32 zeros like each parameter, ``"step"`` an
    int32 0 on the parameters' device; with ``master`` also ``"master"``,
    a float32 copy of each parameter that is not float32."""
    params = dict(params)
    dev = next(iter(params.values())).device if params else None

    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}

    st = {"mu": zeros(), "nu": zeros(),
          "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if master:
        st["master"] = {n: p.detach().to(torch.float32).clone()
                        for n, p in params.items()
                        if p.dtype != torch.float32}
    return st


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of every entry's square over the tensors, in
    float32."""
    total = sum(torch.sum(torch.square(x.to(torch.float32))) for x in tensors)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


# ---------------------------------------------------------------------------
# gradient compression (applied after the cross-replica mean, or
# standalone as an error-bounded quantizer)
# ---------------------------------------------------------------------------

def compress_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, scale)``: one float32 scale, max|g| / 127."""
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def sparsify_topk(g: torch.Tensor, ratio: float) -> torch.Tensor:
    """Keep the entries at least as large in magnitude as the k-th largest
    (k = max(1, int(numel * ratio)); ties at the threshold are kept), zero
    the rest."""
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * ratio))
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    return torch.where(torch.abs(g) >= thresh, g, torch.zeros_like(g))


def maybe_compress_grads(cfg: AdamWConfig, grads: Mapping[str, torch.Tensor]):
    """The gradients quantized and dequantized (``int8``, one scale a
    tensor) or sparsified (``topk``), each in its own type."""
    if cfg.compression == "int8":
        def roundtrip(g):
            q, s = compress_int8(g.to(torch.float32))
            return decompress_int8(q, s).to(g.dtype)

        return {n: roundtrip(g) for n, g in grads.items()}
    if cfg.compression == "topk":
        return {n: sparsify_topk(g, cfg.topk_ratio) for n, g in grads.items()}
    return dict(grads)


_NO_DECAY_KEYS = ("scale", "bias", "A_log", "dt_bias", "lam", "D")


def decay_mask(path: str) -> bool:
    """True where the reference decays the leaf at ``path`` (``"a/b/c"``):
    no key of the path equals one of the no-decay names."""
    return not any(k in _NO_DECAY_KEYS for k in path.split("/"))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
                  grads: Mapping[str, torch.Tensor], state: dict, *,
                  paths: Mapping[str, str] | None = None) -> dict:
    """One AdamW step, in place on ``params`` and ``state``.  Returns the
    metrics ``{"grad_norm", "lr"}`` (tensors, no host sync).  Where the
    state holds a master for a parameter, the update runs on it and the
    parameter becomes its cast."""
    step = state["step"] + 1
    gnorm = global_norm([grads[n] for n in params])
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    masters = state.get("master", {})
    for name, p in params.items():
        ref = masters.get(name)
        if ref is None:
            ref = p if p.dtype == torch.float32 else p.to(torch.float32)
        g = grads[name].to(torch.float32) * clip
        mu, nu = state["mu"][name], state["nu"][name]
        mu.mul_(b1).add_(g, alpha=1 - b1)
        nu.mul_(b2).add_(torch.square(g), alpha=1 - b2)
        del g
        delta = (mu / bc1).div_(torch.sqrt(nu / bc2).add_(cfg.eps))
        path = paths[name] if paths is not None else name
        if decay_mask(path):
            delta.add_(ref, alpha=cfg.weight_decay)
        ref.sub_(delta.mul_(lr))
        if ref is not p:
            p.copy_(ref)
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}
