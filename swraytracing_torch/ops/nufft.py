"""Direct (NUFFT-style, type-2) evaluation of half-plane spectra at
arbitrary points.

Counterpart of swraytracing_tpu/ops/nufft.py. The reference prototypes
this in scratch/fourier_interpolate_test.m as the ground-truth alternative
to Lagrangian stencil interpolation. It is differentiable: the evaluation
is two complex matrix products per batch of points (torch.matmul; the JAX
package computes them outside any kernel too), and gradients w.r.t. the
spectral coefficients flow through linearly.

Cost is O(Np * nx * nky), so use it for validation and for moderate mode
counts; the Lagrangian gather (ops/interp.py) is the production path.
"""

from __future__ import annotations

import numpy as np
import torch

from .grid import SpectralGrid

__all__ = ["eval_spectrum_at", "eval_spectrum_and_grad_at"]


def _phase_matrices(x, y, grid: SpectralGrid, dtype):
    """exp(i x kx) (Np, nx) and exp(i y ky) (Np, nky) in complex `dtype`;
    the wavenumbers in its real dtype, on the device of x."""
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    kx = torch.as_tensor(grid.kx[:, 0], dtype=real, device=x.device)
    ky = torch.as_tensor(grid.ky[0, :], dtype=real, device=x.device)
    ax = torch.exp(1j * (x[:, None] * kx[None, :]))
    ay = torch.exp(1j * (y[:, None] * ky[None, :]))
    return ax.to(dtype), ay.to(dtype)


def _halfplane_weights(grid: SpectralGrid):
    w = np.full((grid.nky,), 2.0)
    w[0] = 1.0
    if grid.ny % 2 == 0:
        w[-1] = 1.0  # Nyquist column is not doubled (masked anyway)
    return w


def _prepare(fk, x, y, grid: SpectralGrid):
    real = fk.real.dtype
    ax, ay = _phase_matrices(x.to(real), y.to(real), grid, fk.dtype)
    w = torch.as_tensor(_halfplane_weights(grid), dtype=fk.dtype,
                        device=fk.device)
    return ax, ay, w


def eval_spectrum_at(fk, x, y, grid: SpectralGrid):
    """Evaluate the real field with half-plane spectrum `fk` at points
    (x, y).

    f(x) = Re sum_k fk e^{i k.x}, with ky>0 columns double-counted for the
    conjugate half-plane. Matches to_grid() at grid points.

    Args:
      fk: (nx, nky) complex spectrum (the normalisation of ops.spectral).
      x, y: (Np,) positions.
    Returns: (Np,) real values.
    """
    ax, ay, w = _prepare(fk, x, y, grid)
    t = ax @ (fk * w)                    # (Np, nky)
    return torch.real((t * ay).sum(-1))


def eval_spectrum_and_grad_at(fk, x, y, grid: SpectralGrid):
    """Evaluate f, df/dx, df/dy at points in one pass (shared phase
    matrices)."""
    ax, ay, w = _prepare(fk, x, y, grid)
    ikx = torch.as_tensor(1j * grid.kx, dtype=fk.dtype, device=fk.device)
    iky = torch.as_tensor(1j * grid.ky, dtype=fk.dtype, device=fk.device)
    f = torch.real(((ax @ (fk * w)) * ay).sum(-1))
    fx = torch.real(((ax @ (fk * ikx * w)) * ay).sum(-1))
    fy = torch.real(((ax @ (fk * iky * w)) * ay).sum(-1))
    return f, fx, fy
