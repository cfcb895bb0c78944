"""Wrapper of the bucket-checksum CUDA kernel (``csrc/checksum.cu``).

Counterpart of ``repro/kernels/checksum_kernel.py`` (``checksum_pallas``).
CUDA tensors only: ``kernels/ops.py`` routes CPU tensors to
``kernels/ref.checksum``.
"""
from __future__ import annotations

import functools

import torch

from . import build
from .route_kernel import stream_of


@functools.cache
def max_width() -> int:
    """The widest key + value row (words) a block's tile holds."""
    return build.load("checksum").repro_checksum_max_width()


def _rows(name: str, t: torch.Tensor) -> torch.Tensor:
    """A 2-d int32 CUDA view whose rows are contiguous: row-strided views
    (slices of a wider buffer) pass as they are, anything else is made
    contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32 or t.dim() != 2:
        raise ValueError(f"{name}: expected a 2-d int32 tensor, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.stride(1) != 1 or t.stride(0) < t.shape[1]:
        t = t.contiguous()
    return t


def checksum(keys: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """(N, KW) x (N, VW) int32 words -> (N,) int32 checksum over
    key || value."""
    keys = _rows("checksum keys", keys)
    vals = _rows("checksum vals", vals)
    n, kw = keys.shape
    vw = vals.shape[1]
    if vals.shape[0] != n:
        raise ValueError("checksum: keys and vals differ in rows")
    out = torch.empty((n,), dtype=torch.int32, device=keys.device)
    if n == 0:
        return out
    if not 1 <= kw + vw <= max_width():
        raise ValueError(f"checksum: row width {kw + vw} outside "
                         f"1..{max_width()}")
    with torch.cuda.device(keys.device):
        build.launch("checksum", "checksum", "repro_checksum",
                     keys.data_ptr(), keys.stride(0), vals.data_ptr(),
                     vals.stride(0), out.data_ptr(), n, kw, vw,
                     stream_of(keys))
    return out
