"""Int8-compressed gradient reduce-scatter over a ``torch.distributed``
group: the port of ``repro/optim/compressed_reduce.py``, whose
``shard_map`` over a mesh axis becomes a process group.

Each rank quantizes its own ``(n,)`` gradient into R int8 chunks (R the
group's size), one float32 scale a chunk; the chunks and scales cross the
group through ``all_to_all_single`` with int8 on the wire (gloo and NCCL
both take int8), and each rank dequantizes and sums only its own chunk:
reduce-scatter order, at ~1/4 of float32's bytes.

Error model (the reference's): per-chunk max-abs quantization; the mean
of R dequantized chunks deviates from the float32 mean by at most the
largest chunk's step/2 elementwise (step = chunk_max / 127).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F


def _quant(x: torch.Tensor):
    """x: (R, C) -> int8 (R, C), scales (R, 1) float32."""
    scale = torch.clamp(torch.amax(torch.abs(x), dim=-1, keepdim=True),
                        min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_reduce(grad: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's chunk of the mean over ``group`` of every rank's
    ``grad`` ((n,) float32, n a multiple of the group's size: see
    ``pad_to``): ``(n / R,)``, chunk r on rank r, computed from int8
    chunks.  Every rank calls it with its own gradient."""
    r = dist.get_world_size(group)
    n = grad.shape[0]
    if grad.dim() != 1 or n % r:
        raise ValueError(f"compressed_reduce: a (n,) gradient with n a "
                         f"multiple of {r} ranks, got {tuple(grad.shape)}")
    q, s = _quant(grad.to(torch.float32).reshape(r, n // r))
    # chunk j goes to rank j; each rank receives every rank's share of
    # its own chunk: int8 on the wire, then the (r, 1) scales
    q_t = torch.empty_like(q)
    s_t = torch.empty_like(s)
    dist.all_to_all_single(q_t, q, group=group)
    dist.all_to_all_single(s_t, s, group=group)
    return torch.sum(_dequant(q_t, s_t), dim=0) / r


def pad_to(x: torch.Tensor, multiple: int) -> torch.Tensor:
    n = x.shape[0]
    m = -(-n // multiple) * multiple
    return F.pad(x, (0, m - n)) if m != n else x


def wire_bytes(n: int, r: int) -> dict:
    """Traffic accounting for the report: int8 path vs f32 all-reduce."""
    int8_path = n * 1 + (r * 4)          # int8 payload + per-chunk scales
    f32_allreduce = n * 4 * 2            # ring all-reduce moves ~2x data
    return {"int8_alltoall": int8_path, "f32_allreduce": f32_allreduce,
            "ratio": f32_allreduce / max(int8_path, 1)}
