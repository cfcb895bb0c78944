"""The kernel switch: a CUDA tensor launches the hand-written kernel, a CPU
tensor takes the plain version in ``kernels/ref.py``.

There is no fallback: on the card a kernel that fails to build or launch
raises.  Mixed devices raise.  ``launches()`` reads the per-kernel launch
counts (incremented only where a kernel is launched, ``build.launch``).
"""
from __future__ import annotations

import torch

from . import (
    apply_kernel,
    build,
    checksum_kernel,
    hash_kernel,
    l1_kernel,
    local_attn_kernel,
    probe_kernel,
    ref,
    round_kernel,
    route_kernel,
    stencil_kernel,
)


def _on_cuda(*tensors: torch.Tensor) -> bool:
    cuda = [t.is_cuda for t in tensors]
    if all(cuda):
        return True
    if any(cuda):
        raise ValueError("kernel inputs lie on different devices")
    return False


def launches() -> dict[str, int]:
    return dict(build.LAUNCHES)


def reset_launches() -> None:
    build.reset_launches()


def route_pack(mat, inv, fill_row):
    if _on_cuda(mat, inv, fill_row):
        return route_kernel.route_pack(mat, inv, fill_row)
    return ref.route_pack(mat, inv, fill_row)


def route_unpack(buf, slot, kept, fill_row):
    if _on_cuda(buf, slot, kept, fill_row):
        return route_kernel.route_unpack(buf, slot, kept, fill_row)
    return ref.route_unpack(buf, slot, kept, fill_row)


def hash64(keys):
    if _on_cuda(keys):
        return hash_kernel.hash64(keys)
    return ref.hash64(keys)


def shard_apply(slab_keys, slab_vals, slab_meta, slab_csum, qkeys, base,
                n_probe: int):
    args = (slab_keys, slab_vals, slab_meta, slab_csum, qkeys, base)
    if _on_cuda(*args):
        return apply_kernel.shard_apply(*args, n_probe)
    return ref.shard_apply(*args, n_probe)


def probe(slab_keys, slab_vals, slab_meta, slab_csum, qkeys, base,
          n_probe: int, validate_checksum: bool = True):
    args = (slab_keys, slab_vals, slab_meta, slab_csum, qkeys, base)
    if _on_cuda(*args):
        return probe_kernel.probe(*args, n_probe, validate_checksum)
    return ref.probe(*args, n_probe, validate_checksum)


def l1_probe(l1_keys, l1_vals, flags, qkeys, set_idx):
    args = (l1_keys, l1_vals, flags, qkeys, set_idx)
    if _on_cuda(*args):
        return l1_kernel.l1_probe(*args)
    return ref.l1_probe(*args)


def checksum(keys, vals):
    if _on_cuda(keys, vals):
        return checksum_kernel.checksum(keys, vals)
    return ref.checksum(keys, vals)


def round_sig(x, sig_digits: int):
    x = x.to(torch.float32)
    if _on_cuda(x):
        return round_kernel.round_sig(x.contiguous(), sig_digits)
    return ref.round_sig(x, sig_digits)


def stencil_keys(x, sig_digits: int, key_words: int, radius: int = 1,
                 coarse_tier: bool = True, n_buckets: int = 1024,
                 n_probe: int = 6):
    x = x.to(torch.float32)
    args = (sig_digits, key_words, radius, coarse_tier, n_buckets, n_probe)
    if _on_cuda(x):
        return stencil_kernel.stencil_keys(x.contiguous(), *args)
    return ref.stencil_keys(x, *args)


def local_attention(q, k, v, window: int):
    """Causal sliding-window attention, q (B, S, H, D), k/v (B, S, Hk, D)
    -> (B, S, H, D); a (BH, S, D) problem is the view ``x[:, :, None]``."""
    if _on_cuda(q, k, v):
        return local_attn_kernel.local_attention(q, k, v, window)
    local_attn_kernel.check_inputs(q, k, v, window)
    return ref.local_attention(q, k, v, window)
