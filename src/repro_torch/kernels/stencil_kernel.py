"""Wrapper of the fused stencil-key CUDA kernel (``csrc/stencil.cu``).

Counterpart of ``repro/kernels/stencil_kernel.py``
(``stencil_keys_pallas``).  The enumeration order is
``core/neighbors.stencil_offsets``, handed to the kernel as an (M, 2)
int32 table.  CUDA tensors only: ``kernels/ops.py`` routes CPU tensors
to ``kernels/ref.stencil_keys``.
"""
from __future__ import annotations

import torch

from ..core.neighbors import stencil_offsets
from . import build
from .route_kernel import check_cuda, stream_of


def stencil_keys(x: torch.Tensor, sig_digits: int, key_words: int,
                 radius: int = 1, coarse_tier: bool = True,
                 n_buckets: int = 1024, n_probe: int = 6):
    """(n, D) contiguous float32 queries -> ``(keys (n, M, KW) int32,
    base (n, M) int32)``, M = 1 + 2 * radius * D (+ 1 coarse)."""
    check_cuda("stencil_keys x", x, 2, dtype=torch.float32)
    if radius < 0 or key_words < 1:
        raise ValueError("stencil_keys: need radius >= 0 and key_words >= 1")
    n, d = x.shape
    table = torch.tensor(stencil_offsets(d, radius, coarse_tier),
                         dtype=torch.int32, device=x.device).reshape(-1)
    m = table.shape[0] // 2
    keys = torch.empty((n, m, key_words), dtype=torch.int32, device=x.device)
    base = torch.empty((n, m), dtype=torch.int32, device=x.device)
    if n == 0:
        return keys, base
    span = max(n_buckets - n_probe + 1, 1)
    with torch.cuda.device(x.device):
        build.launch("stencil_keys", "stencil", "repro_stencil_keys",
                     x.data_ptr(), table.data_ptr(), keys.data_ptr(),
                     base.data_ptr(), n, d, m, key_words, int(sig_digits),
                     span, stream_of(x))
    return keys, base
