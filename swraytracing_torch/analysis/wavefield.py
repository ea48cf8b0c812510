"""Simulated wavefield reconstruction from the packet ensemble.

Counterpart of swraytracing_tpu/analysis/wavefield.py: the visualisation
the reference sketches but never ran (the commented block at
ray_trace_sw/raytrace_sw.m:204-218). Each packet contributes a plane wave
cos(k_p . x - omega_p t) under a Gaussian amplitude envelope A_p(x)
centred at the packet position with peak sqrt(a_p / omega_p)
(equipartition: wave action a = E/omega, surface amplitude ~ sqrt(E/omega)
up to the constant the reference leaves in `ampfunc`), summed over packets
and optionally added to the geostrophic surface eta_g.

The JAX package scans over the packets one at a time; here a loop over
chunks of `_CHUNK` packets adds each chunk's (chunk, nx, ny) waves to the
field, so peak memory stays at a few grids whatever the packet count.
"""

from __future__ import annotations

import torch

from ..ops.grid import SpectralGrid
from ..models.dispersion import Dispersion

__all__ = ["reconstruct_wavefield"]

_CHUNK = 4  # packets per chunk: (_CHUNK, nx, ny) temporaries


def reconstruct_wavefield(x, k, grid: SpectralGrid, disp: Dispersion,
                          t=0.0, action=None, width=None, eta_g=None):
    """Sum of enveloped plane waves at the packet phase-space points.

    Args:
      x: (2, Np) packet positions (coordinate-first, carry layout).
      k: (2, Np) wavevectors.
      grid: target grid.
      disp: dispersion (omega_p = sqrt(f^2 + Cg^2 |k_p|^2), the H=1
        form of cg_sw.m:22 — the reference sketch evaluates a local
        depth; pass a modified Dispersion for that).
      t: evaluation time (phase omega*t, raytrace_sw.m:212).
      action: (Np,) wave action a_p; None = 1 for every packet. The
        envelope peak is sqrt(a_p / omega_p) (raytrace_sw.m:210).
      width: Gaussian envelope scale; the reference's `ampfunc` uses
        2*pi/50 of its domain — default L/50 here.
      eta_g: optional (nx, ny) geostrophic surface to add
        (raytrace_sw.m:216 plots etag + etaw).
    Returns:
      (nx, ny) wavefield (plus eta_g if given), on the device and in the
      dtype of x.
    """
    if width is None:
        width = grid.Lx / 50.0
    X, Y = grid.meshgrid()
    X = torch.as_tensor(X, dtype=x.dtype, device=x.device)
    Y = torch.as_tensor(Y, dtype=x.dtype, device=x.device)
    om = disp.omega(k)
    a = (torch.ones(x.shape[-1], dtype=x.dtype, device=x.device)
         if action is None else torch.as_tensor(action, dtype=x.dtype,
                                                device=x.device))
    amax = torch.sqrt(torch.clamp(a, min=0.0) / om)
    Lx, Ly = grid.Lx, grid.Ly
    eta = torch.zeros(grid.shape, dtype=x.dtype, device=x.device)
    for s in range(0, x.shape[-1], _CHUNK):
        c = slice(s, s + _CHUNK)
        xp, yp = x[0, c, None, None], x[1, c, None, None]
        kx, ky = k[0, c, None, None], k[1, c, None, None]
        w, A = om[c, None, None], amax[c, None, None]
        # periodic displacement: nearest-image Gaussian envelope
        dx = torch.remainder(X - xp + Lx / 2, Lx) - Lx / 2
        dy = torch.remainder(Y - yp + Ly / 2, Ly) - Ly / 2
        env = A * torch.exp(-(dx * dx + dy * dy) / (2.0 * width ** 2))
        # phase anchored at the packet, so the local wavenumber is the
        # packet's and the packet sits on a crest
        eta = eta + (env * torch.cos(kx * dx + ky * dy - w * t)).sum(0)
    if eta_g is None:
        return eta
    return eta + torch.as_tensor(eta_g, dtype=x.dtype, device=x.device)
