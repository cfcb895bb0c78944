"""Key rounding onto the significant-digit lattice (PyTorch port of
``repro.core.neighbors``: ``pow10`` and ``round_significant`` only; the
stencil enumeration waits for the neighbourhood slice).

Keys must be the same function of the input in both packages, or the
lattice splits and a stored result is never found again.  Two steps of
the reference do not carry over bit for bit:

- ``10^e``: the reference takes XLA's ``power(10, e)``, whose bits differ
  from ``torch.pow`` (and whose 10^-38 flushes to 0).  The port reads the
  reference's own f32 bits from the 77-entry table below.
- the decade ``floor(log10 |x|)``: XLA's CPU ``log10`` equals
  ``log(x) * f32(1/ln 10)`` bit for bit, so the port computes exactly that
  product.  ``torch.log`` itself still differs from XLA's ``log`` by an
  ulp on some inputs, which moves the floor only within a few ulps of a
  power of ten: parity holds outside that band (tests pin it).
"""
from __future__ import annotations

import numpy as np
import torch

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
_INV_LN10 = float(np.float32(1.0 / np.log(10.0)))


def pow10(e: torch.Tensor) -> torch.Tensor:
    """10^e for integral float e, clamped to [-38, 38], with the
    reference's bits."""
    table = torch.from_numpy(_POW10_F32).to(e.device)
    idx = torch.clamp(e, -38.0, 38.0).to(torch.int64) + 38
    return table[idx]


def round_significant(x: torch.Tensor, sig_digits: int) -> torch.Tensor:
    """Round to ``sig_digits`` significant decimal digits, elementwise.
    Zeros and denormals map to 0; inf/nan pass through unchanged."""
    x = x.to(torch.float32)
    absx = x.abs()
    finite = torch.isfinite(x)
    tiny = absx < TINY_F32
    safe = torch.where(finite & ~tiny, absx, torch.ones_like(absx))
    inv_ln10 = torch.tensor(_INV_LN10, dtype=torch.float32, device=x.device)
    exp = torch.floor(torch.log(safe) * inv_ln10)
    e = (sig_digits - 1) - exp
    out = torch.round(x * pow10(e)) * pow10(-e)
    out = torch.where(tiny, torch.zeros_like(out), out)
    return torch.where(finite, out, x)
