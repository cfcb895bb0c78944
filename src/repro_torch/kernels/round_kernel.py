"""Wrapper of the significant-digit rounding CUDA kernel
(``csrc/round.cu``).

Counterpart of ``repro/kernels/round_kernel.py`` (``round_sig_pallas``).
CUDA tensors only: ``kernels/ops.py`` routes CPU tensors to
``core/neighbors.round_significant``.
"""
from __future__ import annotations

import torch

from . import build
from .route_kernel import check_cuda, stream_of


def round_sig(x: torch.Tensor, sig_digits: int) -> torch.Tensor:
    """Any-shape contiguous float32 -> float32 rounded to ``sig_digits``
    significant digits, elementwise."""
    check_cuda("round_sig x", x, x.dim(), dtype=torch.float32)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        build.launch("round_sig", "round", "repro_round_sig", x.data_ptr(),
                     out.data_ptr(), x.numel(), int(sig_digits),
                     stream_of(x))
    return out
