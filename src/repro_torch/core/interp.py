"""Inverse-distance-weighted interpolation over neighbourhood cache hits
(PyTorch port of ``repro.core.interp``).

Given the stencil probe results of ``core/neighbors.py`` and
``dht_read_many``, each query row resolves to one of three provenances:

- ``PROV_EXACT``: the centre lattice point itself was cached; the stored
  value is returned untouched;
- ``PROV_INTERP``: no exact hit, but at least ``min_neighbors`` cached
  lattice points lie within ``max_neighbor_dist`` lattice steps; the
  Shepard (inverse-distance-weighted) blend of their values is returned;
- ``PROV_MISS``: neither; the caller pays the solver.

Plain torch: the reference computes this outside any kernel too.
"""
from __future__ import annotations

import dataclasses

import torch

# per-row provenance codes (int32)
PROV_MISS = 0
PROV_EXACT = 1
PROV_INTERP = 2


@dataclasses.dataclass(frozen=True)
class InterpConfig:
    """Neighbourhood-query tuning (same fields and defaults as the
    reference)."""

    radius: int = 1               # stencil: +-radius lattice steps per dim
    coarse_tier: bool = True      # also probe the sig_digits-1 centre
    max_neighbor_dist: float = 2.0  # accept neighbours within this many steps
    min_neighbors: int = 2        # require this many to interpolate
    power: float = 2.0            # IDW exponent (2 = classic Shepard)

    def __post_init__(self):
        if self.radius < 0:
            raise ValueError("radius must be >= 0")
        if self.min_neighbors < 1:
            raise ValueError("min_neighbors must be >= 1")
        if self.max_neighbor_dist <= 0:
            raise ValueError("max_neighbor_dist must be > 0")


def idw_weights(dist: torch.Tensor, usable: torch.Tensor, power: float = 2.0,
                eps: float = 1e-12) -> torch.Tensor:
    """(n, M) step distances and usability mask -> normalised weights."""
    w = torch.where(usable, 1.0 / (dist.to(torch.float32) ** power + eps),
                    0.0)
    total = w.sum(dim=-1, keepdim=True)
    return w / torch.clamp(total, min=eps)


def interpolate(inputs: torch.Tensor, points: torch.Tensor,
                values: torch.Tensor, found: torch.Tensor, step: torch.Tensor,
                icfg: InterpConfig):
    """Resolve each row from its neighbourhood hits.

    ``inputs`` (n, D) unrounded queries, ``points`` (n, M, D) stencil
    points (entry 0 the centre), ``values`` (n, M, O) cached outputs,
    ``found`` (n, M), ``step`` (n, D) lattice step per coordinate.
    Returns ``(outputs (n, O) float32, provenance (n,) int32, stats)``."""
    x = inputs.to(torch.float32)
    delta = (points - x[:, None, :]) / torch.clamp(step[:, None, :],
                                                   min=1e-30)
    dist = torch.sqrt((delta * delta).sum(dim=-1))                # (n, M)

    exact = found[:, 0]
    usable = found & (dist <= icfg.max_neighbor_dist)
    n_usable = usable.sum(dim=-1).to(torch.int32)
    can_interp = ~exact & (n_usable >= icfg.min_neighbors)

    w = idw_weights(dist, usable, icfg.power)
    blended = torch.einsum("nm,nmo->no", w, values.to(torch.float32))

    provenance = torch.where(
        exact, PROV_EXACT, torch.where(can_interp, PROV_INTERP, PROV_MISS)
    ).to(torch.int32)
    outputs = torch.where(
        exact[:, None], values[:, 0].to(torch.float32),
        torch.where(can_interp[:, None], blended, 0.0))
    resolved = provenance != PROV_MISS
    stats = {
        "exact": exact.sum().to(torch.int32),
        "interpolated": can_interp.sum().to(torch.int32),
        "misses": (~resolved).sum().to(torch.int32),
        "neighbors_mean": n_usable.to(torch.float32).mean(),
    }
    return outputs, provenance, stats


__all__ = [
    "InterpConfig",
    "PROV_EXACT",
    "PROV_INTERP",
    "PROV_MISS",
    "idw_weights",
    "interpolate",
]
