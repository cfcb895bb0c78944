"""Wrapper of the fused shard-apply CUDA kernel (``csrc/apply.cu``).

Counterpart of ``repro/kernels/apply_kernel.py`` (``shard_apply_pallas``).
The kernel takes every virtual shard in one launch: the slab flattened to
(S*B, .) and absolute window bases.  A block stages its queries' key and
value rows in shared memory, so a row may be at most :func:`max_width`
words wide (1,812).  CUDA tensors only:
``kernels/ops.py`` routes CPU tensors to ``kernels/ref.shard_apply``.
"""
from __future__ import annotations

import functools

import torch

from . import build
from .route_kernel import check_cuda, stream_of


@functools.cache
def max_width() -> int:
    """The widest key + value row (words) the kernel stages."""
    return build.load("apply").repro_shard_apply_max_width()


def shard_apply(slab_keys: torch.Tensor, slab_vals: torch.Tensor,
                slab_meta: torch.Tensor, slab_csum: torch.Tensor,
                qkeys: torch.Tensor, base: torch.Tensor, n_probe: int):
    """Returns ``(vals (C, VW), found (C,), rsel (C,), wsel (C,),
    wkind (C,))`` int32, with the semantics of ``kernels/ref.shard_apply``."""
    check_cuda("shard_apply slab_keys", slab_keys, 2)
    check_cuda("shard_apply slab_vals", slab_vals, 2)
    check_cuda("shard_apply slab_meta", slab_meta, 1)
    check_cuda("shard_apply slab_csum", slab_csum, 1)
    check_cuda("shard_apply qkeys", qkeys, 2)
    check_cuda("shard_apply base", base, 1)
    nb, kw = slab_keys.shape
    vw = slab_vals.shape[1]
    c = qkeys.shape[0]
    if (slab_vals.shape[0] != nb or slab_meta.shape[0] != nb
            or slab_csum.shape[0] != nb or qkeys.shape[1] != kw
            or base.shape[0] != c or nb == 0 or n_probe < 1):
        raise ValueError("shard_apply: inconsistent shapes")
    if kw + vw > max_width():
        raise ValueError(f"shard_apply: row width {kw + vw} above "
                         f"{max_width()} (a block's shared memory)")
    vals = torch.empty((c, vw), dtype=torch.int32, device=qkeys.device)
    res = torch.empty((c, 4), dtype=torch.int32, device=qkeys.device)
    if c > 0:
        with torch.cuda.device(qkeys.device):
            build.launch(
                "shard_apply", "apply", "repro_shard_apply",
                slab_keys.data_ptr(), slab_vals.data_ptr(),
                slab_meta.data_ptr(), slab_csum.data_ptr(), nb,
                qkeys.data_ptr(), base.data_ptr(), c, kw, vw, n_probe,
                vals.data_ptr(), res.data_ptr(), stream_of(qkeys))
    return vals, res[:, 0], res[:, 1], res[:, 2], res[:, 3]
