"""Wrapper of the read-probe CUDA kernel (``csrc/probe.cu``).

Counterpart of ``repro/kernels/probe_kernel.py`` (``probe_pallas``), with
the engine's semantics (no fall-through past a checksum-failed selected
candidate).  The kernel takes every virtual shard in one launch: the slab
flattened to (S*B, .) and absolute window bases.  CUDA tensors only:
``kernels/ops.py`` routes CPU tensors to ``kernels/ref.probe``.
"""
from __future__ import annotations

import torch

from . import build
from .route_kernel import check_cuda, stream_of


def probe(slab_keys: torch.Tensor, slab_vals: torch.Tensor,
          slab_meta: torch.Tensor, slab_csum: torch.Tensor,
          qkeys: torch.Tensor, base: torch.Tensor, n_probe: int,
          validate_checksum: bool = True):
    """Returns ``(vals (C, VW), found (C,), rsel (C,))`` int32, with the
    semantics of ``kernels/ref.probe``."""
    check_cuda("probe slab_keys", slab_keys, 2)
    check_cuda("probe slab_vals", slab_vals, 2)
    check_cuda("probe slab_meta", slab_meta, 1)
    check_cuda("probe slab_csum", slab_csum, 1)
    check_cuda("probe qkeys", qkeys, 2)
    check_cuda("probe base", base, 1)
    nb, kw = slab_keys.shape
    vw = slab_vals.shape[1]
    c = qkeys.shape[0]
    if (slab_vals.shape[0] != nb or slab_meta.shape[0] != nb
            or slab_csum.shape[0] != nb or qkeys.shape[1] != kw
            or base.shape[0] != c or nb == 0 or n_probe < 1):
        raise ValueError("probe: inconsistent shapes")
    vals = torch.empty((c, vw), dtype=torch.int32, device=qkeys.device)
    res = torch.empty((c, 2), dtype=torch.int32, device=qkeys.device)
    if c > 0:
        with torch.cuda.device(qkeys.device):
            build.launch(
                "probe", "probe", "repro_probe",
                slab_keys.data_ptr(), slab_vals.data_ptr(),
                slab_meta.data_ptr(), slab_csum.data_ptr(), nb,
                qkeys.data_ptr(), base.data_ptr(), c, kw, vw, n_probe,
                int(bool(validate_checksum)), vals.data_ptr(),
                res.data_ptr(), stream_of(qkeys))
    return vals, res[:, 0], res[:, 1]
