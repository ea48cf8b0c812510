"""Gridded flow fields from spectral state.

Counterpart of the spectral constructors of swraytracing_tpu/models/
fields.py (the reference's grid_U.m): velocity and velocity-gradient
grids from a streamfunction or PV spectrum. Off-grid evaluation
(`GriddedFlow.at`, `BlendedFlow`, `AnalyticFlow`) is not part of this
module yet; the fused packet march (ops/march_window.py) interpolates
from these grids itself.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.grid import SpectralGrid
from ..ops import spectral as sp
from .qg import _psik

__all__ = ["GriddedFlow", "flow_from_qk"]

# Field stacking order used throughout: [u, v, u_x, u_y, v_x, v_y].
U, V, UX, UY, VX, VY = range(6)


@dataclasses.dataclass
class GriddedFlow:
    """Gridded (u, v[, grad U]) fields of one flow snapshot."""

    fields: torch.Tensor  # (n_fields, nx, ny) stacked [u, v, ux, uy, vx, vy]
    grid: SpectralGrid
    order: int = 2


def _stack_from_psik(psik, grid: SpectralGrid, shear: float = 0.0,
                     n_fields: int = 6):
    """Streamfunction spectrum -> (n_fields, nx, ny) grids, u = -psi_y,
    v = psi_x, uniform `shear` added to u (grid_U.m:1-18).

    n_fields=2 builds only (u, v): the fused packet march with uv windows
    (ops/march_window.MarchSpec.grad_from_interp) forms grad U itself, so
    the four gradient-grid inverse transforms are skipped entirely."""
    uk = -sp.ddy(psik, grid)
    vk = sp.ddx(psik, grid)
    if n_fields == 2:
        comps = torch.stack([uk, vk])
    else:
        comps = torch.stack([
            uk, vk,
            sp.ddx(uk, grid), sp.ddy(uk, grid),
            sp.ddx(vk, grid), sp.ddy(vk, grid),
        ])
    fields = sp.to_grid(comps, grid)  # batched over the components
    if shear:
        fields[U] += shear  # in place: `fields` is this function's own
    return fields


def flow_from_qk(qk, grid: SpectralGrid, Kd2: float, shear: float = 0.0,
                 order: int = 2, n_fields: int = 6) -> GriddedFlow:
    """QG PV -> velocity/gradient grids; reference grid_U (grid_U.m:1-18):
    psik = -qk/(K_d2 + K2), u = -psi_y, v = psi_x, plus optional uniform
    shear added to u."""
    psik = _psik(qk, grid, Kd2)
    return GriddedFlow(fields=_stack_from_psik(psik, grid, shear, n_fields),
                       grid=grid, order=order)
