"""Wrapper of the batched 64-bit key-hash CUDA kernel (``csrc/hash.cu``).

Counterpart of ``repro/kernels/hash_kernel.py`` (``hash64_pallas``).
CUDA tensors only: ``kernels/ops.py`` routes CPU tensors to
``kernels/ref.hash64``.
"""
from __future__ import annotations

import functools

import torch

from . import build
from .route_kernel import check_cuda, stream_of


@functools.cache
def max_kw() -> int:
    """The widest key (words) the wrapper takes."""
    return build.load("hash").repro_hash64_max_kw()


def hash64(keys: torch.Tensor) -> torch.Tensor:
    """(N, KW) int32 key words -> (N, 2) int32 ``[hi, lo]``."""
    check_cuda("hash64 keys", keys, 2)
    n, kw = keys.shape
    out = torch.empty((n, 2), dtype=torch.int32, device=keys.device)
    if n == 0:
        return out
    if not 1 <= kw <= max_kw():
        raise ValueError(f"hash64: key width {kw} outside 1..{max_kw()}")
    with torch.cuda.device(keys.device):
        build.launch("hash64", "hash", "repro_hash64", keys.data_ptr(),
                     out.data_ptr(), n, kw, stream_of(keys))
    return out
