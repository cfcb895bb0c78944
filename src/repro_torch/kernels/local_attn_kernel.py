"""Wrapper of the sliding-window attention CUDA kernel (``csrc/local_attn.cu``).

Counterpart of ``repro/kernels/local_attn_kernel.py``
(``local_attention_pallas``), generalised to grouped KV heads (query head
h reads KV head ``h // (H // Hk)``), any S >= 1 and window >= 1, and any
strides with the feature axis contiguous, so the model's (B, S, H, D)
projections go in without a transposed copy (the kernel stages rows with
16-byte copies, so a view whose rows are not 16-byte aligned is copied to
a contiguous tensor first).  CUDA tensors only:
``kernels/ops.py`` routes CPU tensors to ``kernels/ref.local_attention``.
"""
from __future__ import annotations

import math

import torch

from . import build
from .route_kernel import stream_of

HEAD_DIMS = (8, 16, 32, 64, 128, 256)   # the instantiations in the source
DTYPES = (torch.float32, torch.bfloat16)


def tolerance(plain_out: torch.Tensor) -> float:
    """Largest |kernel - plain| the kernel is held to on the same inputs:
    both compute in float32 and differ only in the order of the sums, so
    1e-5 for float32 outputs, and for bfloat16 one bf16 ulp (2^-7 of the
    power of two) at the output's largest magnitude, since a sum that
    lands on the other side of a rounding edge moves by one ulp."""
    if plain_out.dtype == torch.float32:
        return 1e-5
    top = float(plain_out.abs().max())
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: int) -> None:
    """Raise unless q (B, S, H, D) and k/v (B, S, Hk, D) share a device and
    a type the kernel takes, H is a multiple of Hk and window >= 1."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"local_attention: expected q (B,S,H,D) and k, v "
                         f"(B,S,Hk,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError("local_attention: q and k/v disagree on B, S or D")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"local_attention: {h} query heads are not a "
                         f"multiple of {k.shape[2]} KV heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("local_attention: q, k and v differ in type")
    if window < 1:
        raise ValueError(f"local_attention: window {window} < 1")


def _rows_aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if every (b, s, h) row starts on a 16-byte boundary, else a
    contiguous copy (whose rows do: D * element size is a multiple of 16
    for every head dim and type the kernel takes)."""
    size = t.element_size()
    if t.data_ptr() % 16 == 0 and all(st * size % 16 == 0
                                      for st in t.stride()[:3]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int) -> torch.Tensor:
    """q (B, S, H, D), k/v (B, S, Hk, D) on the card, float32 or bfloat16,
    feature axis contiguous -> (B, S, H, D) contiguous, q's type."""
    check_inputs(q, k, v, window)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"local_attention {name}: expected a CUDA "
                             f"tensor, got {t.device}")
        if t.stride(3) != 1:
            raise ValueError(f"local_attention {name}: the feature axis "
                             "must be contiguous")
    b, s, h, d = q.shape
    if q.dtype not in DTYPES or d not in HEAD_DIMS:
        raise ValueError(f"local_attention: takes {DTYPES} and head dims "
                         f"{HEAD_DIMS}, got {q.dtype}, D = {d}")
    if b * h > 65535:
        raise ValueError(f"local_attention: B * H = {b * h} > 65535")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    q, k, v = (_rows_aligned(t) for t in (q, k, v))
    strides = [st for t in (q, k, v) for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        build.launch("local_attention", "local_attn", "repro_local_attention",
                     q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     b, s, h, k.shape[2], d, min(int(window), s),
                     int(q.dtype == torch.bfloat16), *strides, stream_of(q))
    return out
