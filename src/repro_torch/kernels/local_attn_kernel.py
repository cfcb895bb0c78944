"""Wrappers of the sliding-window attention CUDA kernels: the forward
(``csrc/local_attn.cu``), its backward (``csrc/local_attn_bwd.cu``) and
the ``torch.autograd.Function`` that joins them for training.

Counterpart of ``repro/kernels/local_attn_kernel.py``
(``local_attention_pallas``), generalised to grouped KV heads (query head
h reads KV head ``h // (H // Hk)``), any S >= 1 and window >= 1, and any
strides with the feature axis contiguous, so the model's (B, S, H, D)
projections go in without a transposed copy (the kernel stages rows with
16-byte copies, so a view whose rows are not 16-byte aligned is copied to
a contiguous tensor first).  CUDA tensors only:
``kernels/ops.py`` routes CPU tensors to ``kernels/ref.local_attention``
(whose own autograd gives the CPU's gradients).
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


def lse_tolerance(plain_lse: torch.Tensor) -> float:
    """Largest |kernel - plain| the forward's log-sum-exp is held to: both
    are float32 from the same float32 scores, summed in another order and
    (bf16) exponentiated by the MUFU's 2^x, ~2^-22 relative, so 1e-5 of
    the largest |lse|, and 1e-5 where that is below 1."""
    top = float(plain_lse.abs().max()) if plain_lse.numel() else 0.0
    return 1e-5 * max(1.0, top)


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
                    window: int, with_lse: bool = False):
    """q (B, S, H, D), k/v (B, S, Hk, D) on the card, float32 or bfloat16,
    feature axis contiguous -> (B, S, H, D) contiguous, q's type.  With
    ``with_lse`` also each row's log-sum-exp of its scaled scores, (B, H,
    S) float32 (``ref.local_attention_lse``), as ``(out, lse)``: the
    backward kernel's input.  The output is the same bits either way."""
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
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    q, k, v = (_rows_aligned(t) for t in (q, k, v))
    strides = [st for t in (q, k, v) for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        build.launch("local_attention", "local_attn", "repro_local_attention",
                     q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     lse.data_ptr() if with_lse else None, b, s, h,
                     k.shape[2], d, min(int(window), s),
                     int(q.dtype == torch.bfloat16), *strides, stream_of(q))
    return (out, lse) if with_lse else out


def bwd_tolerance(plain_grads) -> tuple[float, ...]:
    """Largest |kernel - plain| each of the backward kernel's gradients
    ``(dq, dk, dv)`` is held to, from the plain version's: the sums run
    in another order, so 1e-5 of that gradient's own largest magnitude
    (float32 sums of terms that size), and in bfloat16 at least
    ``tolerance``'s one ulp there.  The floor, 4e-6 of the largest over
    the three, is for a gradient that is zero: at window 1 the plain dq
    and dk are exactly 0, the kernel's are the rounding of two float32
    sums (dP and delta) that cancel, up to 1.37e-6 of dv's magnitude on
    an H100 at (2, 2048, 16/8, 256) in float32."""
    own = [float(g.abs().max()) if g.numel() else 0.0 for g in plain_grads]
    floor = 4e-6 * max(own)
    return tuple(max(1e-5 * m, floor, tolerance(g))
                 if g.dtype == torch.bfloat16 else max(1e-5 * m, floor)
                 for g, m in zip(plain_grads, own))


def local_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, window: int,
                        lse: torch.Tensor):
    """The gradients ``(dq, dk, dv)`` of ``local_attention(q, k, v,
    window)`` whose output was ``out`` and log-sum-exp ``lse`` (both from
    ``local_attention(..., with_lse=True)``), for the output gradient
    ``dout``: q, out, dout (B, S, H, D) and k/v (B, S, Hk, D) on the card,
    one type (float32 or bfloat16), feature axes contiguous; lse (B, H, S)
    float32 contiguous.  Returns contiguous tensors in that type."""
    check_inputs(q, k, v, window)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"local_attention_bwd {name}: expected a CUDA "
                             f"tensor on {q.device}, got {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"local_attention_bwd {name}: type {t.dtype}, "
                             f"q is {q.dtype}")
        if t.stride(3) != 1:
            raise ValueError(f"local_attention_bwd {name}: the feature axis "
                             "must be contiguous")
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"local_attention_bwd: out {tuple(out.shape)} and "
                         f"dout {tuple(dout.shape)} must be q's "
                         f"{tuple(q.shape)}")
    b, s, h, d = q.shape
    hk = k.shape[2]
    if (not lse.is_cuda or lse.device != q.device or lse.dtype != torch.float32
            or lse.shape != (b, h, s) or not lse.is_contiguous()):
        raise ValueError(f"local_attention_bwd lse: expected a contiguous "
                         f"float32 {(b, h, s)} tensor on {q.device}, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")
    if q.dtype not in DTYPES or d not in HEAD_DIMS:
        raise ValueError(f"local_attention_bwd: takes {DTYPES} and head dims "
                         f"{HEAD_DIMS}, got {q.dtype}, D = {d}")
    if b * h > 65535:
        raise ValueError(f"local_attention_bwd: B * H = {b * h} > 65535")
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, hk, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0:
        return dq, dk, dv
    # each row's delta: written by the first kernel, read by the second
    delta = torch.empty_like(lse)
    q, k, v, out, dout = (_rows_aligned(t) for t in (q, k, v, out, dout))
    strides = [st for t in (q, k, v, out, dout) for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        build.launch("local_attention_bwd", "local_attn_bwd",
                     "repro_local_attention_bwd", q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                     dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), b, s, h, hk, d,
                     min(int(window), s), int(q.dtype == torch.bfloat16),
                     *strides, stream_of(q))
    return dq, dk, dv


class LocalAttention(torch.autograd.Function):
    """``local_attention`` with a gradient: the forward kernel, asked for
    each row's log-sum-exp as well, and the backward kernel on what it
    saved (q, k, v, the output and the lse).  Card tensors only, as both
    kernels."""

    @staticmethod
    def forward(ctx, q, k, v, window: int):
        out, lse = local_attention(q, k, v, window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(3) != 1:
            dout = dout.contiguous()
        dq, dk, dv = local_attention_bwd(q, k, v, out, dout, ctx.window, lse)
        return dq, dk, dv, None
