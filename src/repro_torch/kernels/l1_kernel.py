"""Wrapper of the L1-probe CUDA kernel (``csrc/l1.cu``).

Counterpart of ``repro/kernels/l1_kernel.py`` (``l1_probe_pallas``).
CUDA tensors only: ``kernels/ops.py`` routes CPU tensors to
``kernels/ref.l1_probe``.
"""
from __future__ import annotations

import torch

from . import build
from .route_kernel import check_cuda, stream_of


def l1_probe(l1_keys: torch.Tensor, l1_vals: torch.Tensor,
             flags: torch.Tensor, qkeys: torch.Tensor,
             set_idx: torch.Tensor):
    """(sets, ways, KW) and (sets, ways, VW) int32 lines, (sets, ways)
    coherence flags (bool or uint8, one byte each), (n, KW) int32 queries
    and (n,) int32 set indices -> ``(hit (n,) bool, vals (n, VW) int32)``,
    with the semantics of ``kernels/ref.l1_probe``."""
    if flags.dtype == torch.bool:
        flags = flags.view(torch.uint8)
    check_cuda("l1_probe l1_keys", l1_keys, 3)
    check_cuda("l1_probe l1_vals", l1_vals, 3)
    check_cuda("l1_probe flags", flags, 2, dtype=torch.uint8)
    check_cuda("l1_probe qkeys", qkeys, 2)
    check_cuda("l1_probe set_idx", set_idx, 1)
    sets, ways, kw = l1_keys.shape
    vw = l1_vals.shape[2]
    n = qkeys.shape[0]
    if (l1_vals.shape[:2] != (sets, ways) or flags.shape != (sets, ways)
            or qkeys.shape[1] != kw or set_idx.shape[0] != n
            or sets * ways == 0):
        raise ValueError("l1_probe: inconsistent shapes")
    hit = torch.empty((n,), dtype=torch.bool, device=qkeys.device)
    vals = torch.empty((n, vw), dtype=torch.int32, device=qkeys.device)
    if n > 0:
        with torch.cuda.device(qkeys.device):
            build.launch(
                "l1_probe", "l1", "repro_l1_probe",
                l1_keys.data_ptr(), l1_vals.data_ptr(), flags.data_ptr(),
                sets, ways, qkeys.data_ptr(), set_idx.data_ptr(), n, kw, vw,
                hit.data_ptr(), vals.data_ptr(), stream_of(qkeys))
    return hit, vals
