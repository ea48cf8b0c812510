"""Exact solutions of the linear rotating shallow-water equations.

Counterpart of swraytracing_tpu/models/exact_linear.py (the reference's
rsw/lsw.m + rsw/getSk.m): eigendecomposition of the per-mode 3x3 Hermitian
linear SW operator (Salmon's symmetrisation trick h -> C*h), used as
analytic ground truth for the nonlinear RSW solver.

    i dU/dt = L U,  L = [[0, i f, k C], [-i f, 0, l C], [k C, l C, 0]]

per mode (k, l), eigenvalues {0, +W, -W} with W = sqrt(f^2 + C^2 K^2)
(vortical mode + two gravity-wave branches), eigenvectors per
rsw/getSk.m:14-17.

NOTE a reference defect we do NOT replicate: getSk.m:23-26 divides each
eigenvector by its SQUARED norm and then projects with the normalised
vectors again, so the reference's reconstruction is off by 1/|V_j|^2 per
mode — lsw.m does not even reproduce its own initial condition at t=0.
Here the projection is the correct V_j (V_j^H U)/|V_j|^2.

The k=l=0 mean mode, where the gravity-wave eigenvector formulas
degenerate (reference leaves the mean u,v frozen), is handled exactly:
(u + i v)_mean rotates at e^{-i f t}, h_mean is constant.

`linear_sw_solution*` and `plane_wave_ic` are numpy on the host, float64,
as in the JAX package (a validation tool); `geostrophic_ic` goes through
ops/spectral.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.grid import SpectralGrid
from ..ops import spectral as sp

__all__ = ["linear_sw_solution", "linear_sw_solution_1d", "plane_wave_ic",
           "geostrophic_ic"]


def linear_sw_solution_1d(u0, v0, h0, f: float, C: float, times,
                          L: float = 2 * np.pi):
    """1-D exact linear SW evolution (the reference's rsw/lsw1.m intent;
    that file is broken — `length(U,1)` at lsw1.m:17 is not valid
    MATLAB). Implemented as the l=0 slice of the 2-D eigen solution."""
    n = len(np.asarray(u0))
    grid1 = SpectralGrid(nx=n, ny=2, Lx=L, Ly=L)
    tile = lambda a: np.repeat(np.asarray(a)[:, None], 2, axis=1)
    u, v, h = linear_sw_solution(tile(u0), tile(v0), tile(h0), f, C,
                                 times, grid1)
    return u[:, :, 0], v[:, :, 0], h[:, :, 0]


def _fullplane_wavenumbers(grid: SpectralGrid):
    kx = (2 * np.pi / grid.Lx) * np.fft.fftfreq(grid.nx, 1.0 / grid.nx)
    ky = (2 * np.pi / grid.Ly) * np.fft.fftfreq(grid.ny, 1.0 / grid.ny)
    return kx[:, None], ky[None, :]


def linear_sw_solution(u0, v0, h0, f: float, C: float, times,
                       grid: SpectralGrid):
    """Evolve (u, v, h) under the LINEAR rotating SW equations exactly.

    Args:
      u0, v0, h0: (nx, ny) initial fields.
      times: (nt,) evaluation times.
    Returns:
      (u, v, h): each (nt, nx, ny).

    Pure numpy (validation tool; runs host-side in float64).
    """
    u0, v0, h0 = (np.asarray(a, np.float64) for a in (u0, v0, h0))
    times = np.atleast_1d(np.asarray(times, np.float64))
    k, l = _fullplane_wavenumbers(grid)
    K2 = k**2 + l**2
    W = np.sqrt(f**2 + C**2 * K2)

    # spectral ICs with the Hermitian scaling h -> C h (lsw.m:38)
    Uk = np.stack([np.fft.fft2(u0), np.fft.fft2(v0), C * np.fft.fft2(h0)])

    # eigenvectors (getSk.m:14-17), stacked (3 components, nx, ny)
    V0 = np.stack([-1j * l * C + 0 * k, 1j * k * C + 0 * l,
                   f + 0j * K2])
    Vp = np.stack([W * k + 1j * f * l, W * l - 1j * f * k, C * K2 + 0j])
    Vm = np.stack([-W * k + 1j * f * l, -W * l - 1j * f * k, C * K2 + 0j])

    out_u = np.empty((len(times), grid.nx, grid.ny))
    out_v = np.empty_like(out_u)
    out_h = np.empty_like(out_u)

    def project(V):
        E = np.sum(np.abs(V) ** 2, axis=0)
        E = np.where(E == 0, np.inf, E)
        return np.sum(np.conj(V) * Uk, axis=0) / E

    c0, cp, cm = project(V0), project(Vp), project(Vm)
    mean_uv = Uk[0, 0, 0] + 1j * Uk[1, 0, 0]   # (u + i v) mean (complex amp)
    mean_h = Uk[2, 0, 0] / C

    for it, t in enumerate(times):
        Ukt = (c0 * V0 + cp * np.exp(-1j * W * t) * Vp
               + cm * np.exp(1j * W * t) * Vm)
        # mean mode: inertial rotation of (u + iv), constant h; the mean
        # spectral coefficients of real fields are real, so unpack the
        # rotated complex amplitude into its Re (u) and Im (v) parts
        uv_t = mean_uv * np.exp(-1j * f * t)
        Ukt[0, 0, 0] = np.real(uv_t)
        Ukt[1, 0, 0] = np.imag(uv_t)
        Ukt[2, 0, 0] = mean_h * C
        out_u[it] = np.real(np.fft.ifft2(Ukt[0]))
        out_v[it] = np.real(np.fft.ifft2(Ukt[1]))
        out_h[it] = np.real(np.fft.ifft2(Ukt[2])) / C
    return out_u, out_v, out_h


def plane_wave_ic(grid: SpectralGrid, f: float, C: float, k_int: int,
                  l_int: int, eta0: float = 0.01, sign: int = +1,
                  phase: float = 0.0):
    """Single gravity-wave plane wave (u, v, h) in exact linear balance —
    the rsw/onewave.m construction with theta = k x + l y + phase:
      h = eta0 cos(theta)
      u = eta0 (k w cos(theta) - l f sin(theta)) / K2
      v = eta0 (l w cos(theta) + k f sin(theta)) / K2
    with w = sign * sqrt(f^2 + C^2 K^2). This is an exact eigenmode of
    the linear system, translating at w (onewave.m:1-8; note the u,v
    there are per unit C^2=gH=1 scaling, as in the nondimensional swk).
    """
    X, Y = grid.meshgrid()
    k = (2 * np.pi / grid.Lx) * k_int
    l = (2 * np.pi / grid.Ly) * l_int
    K2 = k * k + l * l
    w = sign * np.sqrt(f**2 + C**2 * K2)
    th = k * X + l * Y + phase
    h = eta0 * np.cos(th)
    u = eta0 * C**2 * (k * w * np.cos(th) - l * f * np.sin(th)) / (C**2 * K2)
    v = eta0 * C**2 * (l * w * np.cos(th) + k * f * np.sin(th)) / (C**2 * K2)
    return u, v, h


def geostrophic_ic(grid: SpectralGrid, f: float, C: float, psi):
    """Geostrophically balanced (u, v, h) from a streamfunction grid:
    u = -psi_y, v = psi_x, h = f psi / C^2 (zero linear PV perturbation
    of the vortical mode; cf. rsw/swexamples.m geostrophic IC).

    A tensor `psi` gives tensors on its device in its dtype. A numpy
    `psi` is an initial condition built on the host, as the IC functions of
    models/examples.py build theirs: float64 CPU tensors through the same
    transforms, numpy arrays out."""
    if not isinstance(psi, torch.Tensor):
        u, v, h = geostrophic_ic(grid, f, C, torch.as_tensor(
            np.asarray(psi), dtype=torch.float64, device="cpu"))
        return u.numpy(), v.numpy(), h.numpy()
    psik = sp.to_spectral(psi, grid)
    u = sp.to_grid(-sp.ddy(psik, grid), grid)
    v = sp.to_grid(sp.ddx(psik, grid), grid)
    h = f / C**2 * psi
    return u, v, h
