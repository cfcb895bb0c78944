"""Key rounding and stencil enumeration on the significant-digit lattice
(PyTorch port of ``repro.core.neighbors``).

The key space is a lattice: every stored key is a vector rounded to
``sig_digits`` significant digits.  A neighbourhood query enumerates, per
row, the centre (its own rounded point), a star stencil of +-1..radius
lattice steps per dimension (each point re-rounded), and optionally the
coarse-tier point (the centre rounded at ``sig_digits - 1``, re-expressed
on the ``sig_digits`` lattice).  The order is the static list
:func:`stencil_offsets`, which the stencil kernel
(``kernels/csrc/stencil.cu``) derives in closed form from the entry
index; its keys must match these bit for bit.

Keys must be the same function of the input in both packages, or the
lattice splits and a stored result is never found again.  Two steps of
the reference do not carry over bit for bit:

- ``10^e``: the reference takes XLA's ``power(10, e)``, whose bits differ
  from ``torch.pow`` (and whose 10^-38 flushes to 0).  The port reads the
  reference's own f32 bits from the 77-entry table below.
- the decade ``floor(log10 |x|)``: XLA's CPU ``log10`` equals
  ``log(x) * f32(1/ln 10)`` bit for bit, so the port computes exactly that
  product (here and in :func:`lattice_step`).  ``torch.log`` itself still
  differs from XLA's ``log`` by an ulp on some inputs, which moves the
  floor only within a few ulps of a power of ten: parity holds outside
  that band (tests pin it).

A stencil point is ``c + off * step`` as two rounded operations, never a
fused multiply-add: for radius >= 3 ``off * step`` is inexact.  On the
card the engine's callers round through the ``round_sig`` and
``stencil_keys`` kernels (``kernels/ops.py``); the functions here are
their plain versions.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .layout import pack_floats

# smallest positive normal float32: denormals round to 0
TINY_F32 = 1.1754944e-38

# f32 bits of the reference's pow10(e) for e = -38 .. 38
_POW10_BITS = (
    0x00000000, 0x02081CEA, 0x03AA2425, 0x0554AD2E, 0x0704EC3D, 0x08A6274C,
    0x0A4FB11F, 0x0C01CEB3, 0x0DA24260, 0x0F4AD2F8, 0x10FD87B6, 0x129E74D2,
    0x14461206, 0x15F79688, 0x179ABE15, 0x19416D9A, 0x1AF1C901, 0x1C971DA0,
    0x1E3CE508, 0x1FEC1E4A, 0x219392EF, 0x233877AA, 0x24E69595, 0x26901D7D,
    0x283424DC, 0x29E12E13, 0x2B8CBCCC, 0x2D2FEBFF, 0x2EDBE6FF, 0x3089705F,
    0x322BCC77, 0x33D6BF95, 0x358637BD, 0x3727C5AC, 0x38D1B717, 0x3A83126F,
    0x3C23D70A, 0x3DCCCCCD, 0x3F800000, 0x41200000, 0x42C80000, 0x447A0000,
    0x461C4000, 0x47C35000, 0x49742400, 0x4B189680, 0x4CBEBC20, 0x4E6E6B28,
    0x501502F9, 0x51BA43B7, 0x5368D4A5, 0x551184E7, 0x56B5E621, 0x58635FA9,
    0x5A0E1BCA, 0x5BB1A2BC, 0x5D5E0B6B, 0x5F0AC723, 0x60AD78EC, 0x6258D727,
    0x64078678, 0x65A96816, 0x6753C21C, 0x69045951, 0x6AA56FA6, 0x6C4ECB8F,
    0x6E013F39, 0x6FA18F08, 0x7149F2CA, 0x72FC6F7C, 0x749DC5AE, 0x76453719,
    0x77F684DF, 0x799A130C, 0x7B4097CE, 0x7CF0BDC2, 0x7E967699,
)
_POW10_F32 = np.array(_POW10_BITS, np.uint32).view(np.float32)
# f32(1 / ln 10) as a Python float: exact in float32, so a float32 tensor
# times it is the product with the f32 constant, with no tensor to copy
_INV_LN10 = float(np.float32(1.0 / np.log(10.0)))


@functools.cache
def _pow10_table(device: torch.device) -> torch.Tensor:
    """The pow10 table on ``device``, copied there once."""
    return torch.from_numpy(_POW10_F32).to(device)


def pow10(e: torch.Tensor) -> torch.Tensor:
    """10^e for integral float e, clamped to [-38, 38], with the
    reference's bits."""
    idx = torch.clamp(e, -38.0, 38.0).to(torch.int64) + 38
    return _pow10_table(e.device)[idx]


def stencil_offsets(n_dims: int, radius: int,
                    coarse_tier: bool = True) -> list[tuple[int, int]]:
    """Static (dim, offset) enumeration shared by the plain version and the
    kernel: the centre ``(-1, 0)``, then ring r = 1..radius, each
    dimension in order, +r before -r, then ``(-2, 0)`` for the coarse
    tier.  ``1 + 2 * radius * n_dims (+ 1)`` entries."""
    out: list[tuple[int, int]] = [(-1, 0)]
    for r in range(1, radius + 1):
        for d in range(n_dims):
            out.append((d, r))
            out.append((d, -r))
    if coarse_tier:
        out.append((-2, 0))
    return out


def n_stencil(n_dims: int, radius: int, coarse_tier: bool = True) -> int:
    return 1 + 2 * radius * n_dims + (1 if coarse_tier else 0)


def _decade(x: torch.Tensor):
    """``(finite, tiny, floor(log10 |x|))`` with the F1 log form; the
    decade of zeros, denormals and non-finite values is that of 1."""
    absx = x.abs()
    finite = torch.isfinite(x)
    tiny = absx < TINY_F32
    safe = torch.where(finite & ~tiny, absx, torch.ones_like(absx))
    return finite, tiny, torch.floor(torch.log(safe) * _INV_LN10)


def round_significant(x: torch.Tensor, sig_digits: int) -> torch.Tensor:
    """Round to ``sig_digits`` significant decimal digits, elementwise.
    Zeros and denormals map to 0; inf/nan pass through unchanged."""
    x = x.to(torch.float32)
    finite, tiny, exp = _decade(x)
    e = (sig_digits - 1) - exp
    out = torch.round(x * pow10(e)) * pow10(-e)
    out = torch.where(tiny, torch.zeros_like(out), out)
    return torch.where(finite, out, x)


def lattice_step(x_rounded: torch.Tensor, sig_digits: int) -> torch.Tensor:
    """One lattice step at each coordinate's magnitude: the unit in the
    last significant place, ``10^(floor(log10 |x|) - (sig_digits - 1))``.
    Zeros step at ``10^-(sig_digits - 1)``."""
    _finite, _tiny, exp = _decade(x_rounded.to(torch.float32))
    return pow10(exp - (sig_digits - 1))


def stencil_points(inputs: torch.Tensor, sig_digits: int, radius: int = 1,
                   coarse_tier: bool = True) -> torch.Tensor:
    """(n, D) queries -> (n, M, D) float32 lattice points, each a fixed
    point of the ``sig_digits`` rounding (offsets are re-rounded)."""
    center = round_significant(inputs, sig_digits)
    step = lattice_step(center, sig_digits)
    entries = []
    for dim, off in stencil_offsets(inputs.shape[-1], radius, coarse_tier):
        if dim == -1:
            entries.append(center)
        elif dim == -2:
            entries.append(round_significant(
                round_significant(center, sig_digits - 1), sig_digits))
        else:
            p = center.clone()
            p[..., dim] = center[..., dim] + off * step[..., dim]
            entries.append(round_significant(p, sig_digits))
    return torch.stack(entries, dim=-2)


def stencil_keys(inputs: torch.Tensor, sig_digits: int, key_words: int,
                 radius: int = 1, coarse_tier: bool = True):
    """(n, D) queries -> packed keys (n, M, KW) int32 and the points
    (n, M, D): the plain version of the stencil kernel's keys."""
    points = stencil_points(inputs, sig_digits, radius, coarse_tier)
    return pack_floats(points, key_words), points


def dedup_mask(keys: torch.Tensor) -> torch.Tensor:
    """(n, M, KW) stencil keys -> (n, M) bool, True on the first
    occurrence of each distinct key within a row (re-rounding collapses
    entries at decade boundaries).  O(M^2) per row."""
    eq = (keys[:, :, None, :] == keys[:, None, :, :]).all(dim=-1)
    m = keys.shape[1]
    earlier = torch.tril(torch.ones((m, m), dtype=torch.bool,
                                    device=keys.device), diagonal=-1)
    return ~(eq & earlier[None]).any(dim=-1)
