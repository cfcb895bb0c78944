"""Wrappers of the routing pack/unpack CUDA kernels (``csrc/route.cu``).

Counterparts of ``repro/kernels/route_kernel.py`` (``route_pack_pallas``,
``route_unpack_pallas``).  CUDA tensors only: ``kernels/ops.py`` routes
CPU tensors to the plain versions in ``kernels/ref.py``.
"""
from __future__ import annotations

import torch

from . import build


def check_cuda(name: str, t: torch.Tensor, ndim: int,
               dtype=torch.int32) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` with
    ``ndim`` dimensions: the kernels take nothing else."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-d {dtype} "
                         f"tensor, got {tuple(t.shape)} {t.dtype}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def route_pack(mat: torch.Tensor, inv: torch.Tensor,
               fill_row: torch.Tensor) -> torch.Tensor:
    """(n, L) int32 lanes, (rows,) int32 inverse permutation (-1 = fill),
    (L,) int32 fill row -> (rows, L) int32 send buffer."""
    check_cuda("route_pack mat", mat, 2)
    check_cuda("route_pack inv", inv, 1)
    check_cuda("route_pack fill_row", fill_row, 1)
    n, width = mat.shape
    if fill_row.shape[0] != width:
        raise ValueError("route_pack: fill row width differs from mat")
    rows = inv.shape[0]
    out = torch.empty((rows, width), dtype=torch.int32, device=mat.device)
    if rows * width == 0:
        return out
    with torch.cuda.device(mat.device):
        build.launch("route_pack", "route", "repro_route_pack",
                     mat.data_ptr(), inv.data_ptr(), fill_row.data_ptr(),
                     out.data_ptr(), n, rows, width, stream_of(mat))
    return out


def route_unpack(buf: torch.Tensor, slot: torch.Tensor, kept: torch.Tensor,
                 fill_row: torch.Tensor) -> torch.Tensor:
    """(rows, L) int32 reply buffer, (n,) int32 slot and kept flags, (L,)
    fill row -> (n, L) int32 in item order."""
    check_cuda("route_unpack buf", buf, 2)
    check_cuda("route_unpack slot", slot, 1)
    check_cuda("route_unpack kept", kept, 1)
    check_cuda("route_unpack fill_row", fill_row, 1)
    rows, width = buf.shape
    n = slot.shape[0]
    if kept.shape[0] != n or fill_row.shape[0] != width:
        raise ValueError("route_unpack: slot/kept/fill shapes disagree")
    out = torch.empty((n, width), dtype=torch.int32, device=buf.device)
    if n * width == 0:
        return out
    if rows == 0:
        raise ValueError("route_unpack: empty reply buffer")
    with torch.cuda.device(buf.device):
        build.launch("route_unpack", "route", "repro_route_unpack",
                     buf.data_ptr(), slot.data_ptr(), kept.data_ptr(),
                     fill_row.data_ptr(), out.data_ptr(), n, rows, width,
                     stream_of(buf))
    return out
