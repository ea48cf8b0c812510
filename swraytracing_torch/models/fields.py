"""Flow-field abstraction: evaluate U and grad(U) at packet positions.

Counterpart of swraytracing_tpu/models/fields.py, after the reference's
RaytracingScheme family (RaytracingScheme.m, SpectralScheme.m) and the
procedural grid_U + interpolate_U path (qg_flow_ray_trace/grid_U.m,
interpolate_U.m): velocity and velocity-gradient grids from a
streamfunction or PV spectrum, and their evaluation off the grid by
Lagrangian stencil interpolation (`GriddedFlow.at`), which returns a
FlowEval of (u, v, u_x, u_y, v_x, v_y) at the packet positions.

`BlendedFlow` blends two snapshots linearly in the within-step time
fraction `alpha` (interpolate_U.m:19-23); it is the flow of the per-stage
packet path of models/coupled.py. Both flows take prebuilt interpolation
windows (`.windowed()`, ops/interp.build_windows), which the coupled
models use from `window_min_np` packets on. The fused packet march
(ops/march_window.py) interpolates from the grids itself and does not go
through `.at`. `AnalyticFlow` evaluates a closed-form streamfunction
(models/analytic.py): velocities and gradients by autograd, exact and
differentiable w.r.t. its parameters.

An ensemble's members (parallel/ensemble.py) carry (E, nf, nx, ny) grids:
`flow_from_qk` takes (E, nx, nky) spectra, and `BlendedFlow.at` evaluates
member e's grids at positions (E, Np) row e, giving (E, Np) values.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from ..ops.grid import SpectralGrid
from ..ops import spectral as sp
from ..ops.interp import (stencil_and_weights, interp_stencil_apply,
                          build_windows, interp_windowed)
from .qg import _psik

__all__ = ["FlowEval", "GriddedFlow", "BlendedFlow", "AnalyticFlow",
           "flow_from_qk", "flow_from_psik", "flow_from_psi_grid"]

# Field stacking order used throughout: [u, v, u_x, u_y, v_x, v_y].
U, V, UX, UY, VX, VY = range(6)


class FlowEval(NamedTuple):
    """Velocity and velocity-gradient tensor at packet positions."""

    u: torch.Tensor
    v: torch.Tensor
    u_x: torch.Tensor
    u_y: torch.Tensor
    v_x: torch.Tensor
    v_y: torch.Tensor

    @property
    def uv(self):
        """(2, Np) velocity, coordinate axis first."""
        return torch.stack([self.u, self.v], dim=0)

    def refraction(self, k):
        """(grad U)^T k — the ray refraction term dk/dt = -(grad U)^T k
        (RaytracingScheme.m:9-16). k is (2, Np) coordinate-first."""
        kk, ll = k[0], k[1]
        return torch.stack(
            [self.u_x * kk + self.v_x * ll, self.u_y * kk + self.v_y * ll],
            dim=0)

    # Derived diagnostics (RaytracingScheme.m:18-31)
    @property
    def vorticity(self):
        return self.v_x - self.u_y

    @property
    def strain(self):
        return torch.sqrt((self.u_x - self.v_y) ** 2
                          + (self.v_x + self.u_y) ** 2)

    @property
    def okubo_weiss(self):
        # sigma^2 - zeta^2 in the standard convention
        return (self.u_x - self.v_y) ** 2 + (self.v_x + self.u_y) ** 2 \
            - (self.v_x - self.u_y) ** 2


@dataclasses.dataclass
class GriddedFlow:
    """Flow given by gridded (u, v, grad U) fields, evaluated off-grid by
    Lagrangian stencil interpolation — the SpectralScheme equivalent."""

    fields: torch.Tensor  # (n_fields, nx, ny) stacked [u, v, ux, uy, vx, vy]
    grid: SpectralGrid
    order: int = 2
    win: torch.Tensor | None = None  # optional prebuilt windows

    def windowed(self) -> "GriddedFlow":
        """A copy with the interpolation windows prebuilt: one gathered row
        per packet instead of S*S point gathers (ops/interp.build_windows)."""
        return dataclasses.replace(
            self, win=build_windows(self.fields, self.order))

    def at(self, x, y, alpha=0.0) -> FlowEval:
        """The six fields at positions x, y (Np,); a steady flow ignores
        the within-step time fraction `alpha`."""
        if self.win is not None:
            return FlowEval(*interp_windowed(
                self.win, self.fields.shape[0], x, y, self.grid, self.order))
        ix, iy, wx, wy = stencil_and_weights(x, y, self.grid, self.order)
        vals = interp_stencil_apply(self.fields, ix, iy, wx, wy)
        return FlowEval(*vals)

    def velocity_at(self, x, y, alpha=0.0):
        ix, iy, wx, wy = stencil_and_weights(x, y, self.grid, self.order)
        vals = interp_stencil_apply(self.fields[:2], ix, iy, wx, wy)
        return vals[0], vals[1]


@dataclasses.dataclass
class BlendedFlow:
    """Two flow snapshots blended linearly in within-step time `alpha`,
    as the reference's interpolate_U (interpolate_U.m:19-23). The twelve
    per-snapshot interpolations share one stencil computation."""

    fields1: torch.Tensor  # (6, nx, ny) at step start; (E, 6, nx, ny)
    fields2: torch.Tensor  # (6, nx, ny) at step end    for members
    grid: SpectralGrid
    order: int = 2
    win1: torch.Tensor | None = None  # optional prebuilt windows
    win2: torch.Tensor | None = None

    def windowed(self) -> "BlendedFlow":
        """Prebuild interpolation windows for both snapshots (once per flow
        step); each eval then blends the window arrays and gathers one row
        per packet."""
        return dataclasses.replace(
            self, win1=build_windows(self.fields1, self.order),
            win2=build_windows(self.fields2, self.order))

    def at(self, x, y, alpha) -> FlowEval:
        # Blend the GRIDS (or windows) first, then interpolate once:
        # interpolation is linear, so this equals blending the twelve
        # interpolated values, at half the gathers.
        if self.win1 is not None:
            w = (1.0 - alpha) * self.win1 + alpha * self.win2
            return FlowEval(*interp_windowed(
                w, self.fields1.shape[-3], x, y, self.grid, self.order))
        ix, iy, wx, wy = stencil_and_weights(x, y, self.grid, self.order)
        blended = (1.0 - alpha) * self.fields1 + alpha * self.fields2
        return FlowEval(*interp_stencil_apply(blended, ix, iy, wx, wy))

    def velocity_at(self, x, y, alpha):
        ix, iy, wx, wy = stencil_and_weights(x, y, self.grid, self.order)
        blended = ((1.0 - alpha) * self.fields1[:2]
                   + alpha * self.fields2[:2])
        vals = interp_stencil_apply(blended, ix, iy, wx, wy)  # (2, Np)
        return vals[0], vals[1]


@dataclasses.dataclass
class AnalyticFlow:
    """Flow defined by an analytic streamfunction psi(x, y, t, params);
    u = -psi_y, v = psi_x and the gradient tensor come from
    torch.autograd.grad of psi (create_graph=True).

    Replaces DifferenceScheme.m (finite differences of a psi handle) with
    exact derivatives. `params` maps names to 0-dim tensors. psi must be
    elementwise in (x, y) (each point's value depends on that point
    only), so the gradient of the sum over the points is each point's own
    derivative. Where the positions, a parameter or a tensor `t` require
    grad (and grad mode is on), the values returned by `at` stay
    differentiable w.r.t. them, to any order, so rays are differentiable
    w.r.t. the flow's coefficients; otherwise they come back detached."""

    params: Any
    t: torch.Tensor | float = 0.0
    psi: Callable = None

    def _graph_wanted(self, x, y):
        leaves = [x, y, *self.params.values()]
        if isinstance(self.t, torch.Tensor):
            leaves.append(self.t)
        return torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in leaves)

    def _derivatives(self, x, y, second: bool):
        """(psi_x, psi_y) and, if `second`, (psi_xx, psi_xy, psi_yy) at
        positions x, y (Np,)."""
        keep = self._graph_wanted(x, y)
        with torch.enable_grad():
            # differentiate w.r.t. the positions themselves where they are
            # in a graph, else w.r.t. fresh leaves holding their values
            xx = x if keep and x.requires_grad else \
                x.detach().requires_grad_(True)
            yy = y if keep and y.requires_grad else \
                y.detach().requires_grad_(True)
            psi = self.psi(xx, yy, self.t, self.params)
            gx, gy = torch.autograd.grad(psi.sum(), (xx, yy),
                                         create_graph=True,
                                         materialize_grads=True)
            out = [gx, gy]
            if second:
                hxx, hxy = torch.autograd.grad(
                    gx.sum(), (xx, yy), retain_graph=True, create_graph=keep,
                    materialize_grads=True)
                (hyy,) = torch.autograd.grad(gy.sum(), (yy,),
                                             create_graph=keep,
                                             materialize_grads=True)
                out += [hxx, hxy, hyy]
        return out if keep else [a.detach() for a in out]

    def at(self, x, y, alpha=0.0) -> FlowEval:
        """u, v and the gradient tensor at positions x, y (Np,); a steady
        flow ignores `alpha`."""
        gx, gy, hxx, hxy, hyy = self._derivatives(x, y, second=True)
        return FlowEval(u=-gy, v=gx, u_x=-hxy, u_y=-hyy, v_x=hxx, v_y=hxy)

    def velocity_at(self, x, y, alpha=0.0):
        gx, gy = self._derivatives(x, y, second=False)
        return -gy, gx

    def streamfunction(self, x, y):
        return self.psi(x, y, self.t, self.params)


def _stack_from_psik(psik, grid: SpectralGrid, shear: float = 0.0,
                     n_fields: int = 6):
    """Streamfunction spectrum -> (n_fields, nx, ny) grids, u = -psi_y,
    v = psi_x, uniform `shear` added to u (grid_U.m:1-18). Leading axes of
    psik (an ensemble's members) come first: (E, nx, nky) -> (E, n_fields,
    nx, ny).

    n_fields=2 builds only (u, v): the fused packet march with uv windows
    (ops/march_window.MarchSpec.grad_from_interp) forms grad U itself, so
    the four gradient-grid inverse transforms are skipped entirely."""
    uk = -sp.ddy(psik, grid)
    vk = sp.ddx(psik, grid)
    if n_fields == 2:
        comps = torch.stack([uk, vk], dim=-3)
    else:
        comps = torch.stack([
            uk, vk,
            sp.ddx(uk, grid), sp.ddy(uk, grid),
            sp.ddx(vk, grid), sp.ddy(vk, grid),
        ], dim=-3)
    fields = sp.to_grid(comps, grid)  # batched over the components
    if shear:
        fields[..., U, :, :] += shear  # in place: this function's own
    return fields


def flow_from_qk(qk, grid: SpectralGrid, Kd2: float, shear: float = 0.0,
                 order: int = 2, n_fields: int = 6) -> GriddedFlow:
    """QG PV -> velocity/gradient grids; reference grid_U (grid_U.m:1-18):
    psik = -qk/(K_d2 + K2), u = -psi_y, v = psi_x, plus optional uniform
    shear added to u."""
    psik = _psik(qk, grid, Kd2)
    return GriddedFlow(fields=_stack_from_psik(psik, grid, shear, n_fields),
                       grid=grid, order=order)


def flow_from_psik(psik, grid: SpectralGrid, order: int = 2) -> GriddedFlow:
    """Streamfunction spectrum -> GriddedFlow; the SpectralScheme
    constructor (SpectralScheme.m:16-35)."""
    return GriddedFlow(fields=_stack_from_psik(psik, grid), grid=grid,
                       order=order)


def flow_from_psi_grid(psi, grid: SpectralGrid, order: int = 2) -> GriddedFlow:
    return flow_from_psik(sp.to_spectral(psi, grid), grid, order)
