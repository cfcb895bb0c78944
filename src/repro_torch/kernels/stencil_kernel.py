"""Wrapper of the fused stencil-key CUDA kernel (``csrc/stencil.cu``).

Counterpart of ``repro/kernels/stencil_kernel.py``
(``stencil_keys_pallas``).  The kernel derives each entry's (dim, offset)
of ``core/neighbors.stencil_offsets`` from the entry index, so a call
copies nothing from the host and never waits for the card.  A warp keeps
the coordinates that reach the key, ``min(D, ceil(KW / 2))``, in shared
memory: at most :func:`max_dims`.  CUDA tensors only: ``kernels/ops.py``
routes CPU tensors to ``kernels/ref.stencil_keys``.
"""
from __future__ import annotations

import functools

import torch

from ..core.neighbors import n_stencil
from . import build
from .route_kernel import check_cuda, stream_of


@functools.cache
def max_dims() -> int:
    """The most coordinates a key can hold, ``min(D, ceil(KW / 2))``."""
    return build.load("stencil").repro_stencil_keys_max_dims()


def stencil_keys(x: torch.Tensor, sig_digits: int, key_words: int,
                 radius: int = 1, coarse_tier: bool = True,
                 n_buckets: int = 1024, n_probe: int = 6):
    """(n, D) contiguous float32 queries -> ``(keys (n, M, KW) int32,
    base (n, M) int32)``, M = 1 + 2 * radius * D (+ 1 coarse)."""
    check_cuda("stencil_keys x", x, 2, dtype=torch.float32)
    if radius < 0 or key_words < 1:
        raise ValueError("stencil_keys: need radius >= 0 and key_words >= 1")
    n, d = x.shape
    if min(d, (key_words + 1) // 2) > max_dims():
        raise ValueError(f"stencil_keys: keys of more than {max_dims()} "
                         "coordinates")
    m = n_stencil(d, radius, coarse_tier)
    keys = torch.empty((n, m, key_words), dtype=torch.int32, device=x.device)
    base = torch.empty((n, m), dtype=torch.int32, device=x.device)
    if n == 0:
        return keys, base
    span = max(n_buckets - n_probe + 1, 1)
    with torch.cuda.device(x.device):
        build.launch("stencil_keys", "stencil", "repro_stencil_keys",
                     x.data_ptr(), keys.data_ptr(), base.data_ptr(), n, d,
                     radius, int(coarse_tier), key_words, int(sig_digits),
                     span, stream_of(x))
    return keys, base
