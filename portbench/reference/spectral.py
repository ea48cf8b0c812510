"""Doubly periodic spectral grid and transforms, plain.

Copied from swraytracing_torch/ops/grid.py and ops/spectral.py (commit
701921e): rfft2 half-plane layout (nx, ny//2 + 1); the forward transform
divides by nx*ny and zeroes the Nyquist row and column, the inverse
multiplies by nx*ny; the Jacobian is the plain (aliased) pseudo-spectral
product, as the configurations run it (dealias off).
"""

import math

import numpy as np
import torch


class Grid:
    """Wavenumber arrays of an nx x ny periodic box of side L, as tensors of
    `dtype` on `device`."""

    def __init__(self, nx, L, device, dtype=torch.float64):
        self.nx = self.ny = int(nx)
        self.L = float(L)
        self.dx = self.dy = self.L / self.nx
        self.nky = self.ny // 2 + 1
        self.kmax = self.nx // 2 - 1
        self.device, self.dtype = torch.device(device), dtype
        kx = 2 * math.pi / self.L * np.fft.fftfreq(self.nx, 1.0 / self.nx)
        ky = 2 * math.pi / self.L * np.arange(self.nky)
        mask = np.ones((self.nx, self.nky))
        mask[self.nx // 2, :] = 0.0
        mask[:, -1] = 0.0
        self.kx_np = kx[:, None]
        self.ky_np = ky[None, :]
        self.K2_np = self.kx_np ** 2 + self.ky_np ** 2
        self.mask_np = mask
        t = self.t
        self.kx, self.ky = t(self.kx_np), t(self.ky_np)
        self.K2, self.mask = t(self.K2_np), t(mask)

    def t(self, a, dtype=None):
        return torch.as_tensor(a, dtype=dtype or self.dtype,
                               device=self.device)

    def to_spectral(self, f):
        return torch.fft.rfft2(f) / (self.nx * self.ny) * self.mask

    def to_grid(self, fk):
        return torch.fft.irfft2(fk, s=(self.nx, self.ny)) * (self.nx * self.ny)

    def ddx(self, fk):
        return fk * (1j * self.kx)

    def ddy(self, fk):
        return fk * (1j * self.ky)

    def jacobian(self, ak, bk):
        """Spectrum of a_x b_y - a_y b_x, products on the grid (aliased)."""
        ax, ay = self.to_grid(self.ddx(ak)), self.to_grid(self.ddy(ak))
        bx, by = self.to_grid(self.ddx(bk)), self.to_grid(self.ddy(bk))
        return self.to_spectral(ax * by - ay * bx)

    def velocity(self, psik, shear=0.0):
        """(..., 2, nx, ny) grids u = -psi_y + shear, v = psi_x."""
        u = self.to_grid(-self.ddy(psik)) + shear
        v = self.to_grid(self.ddx(psik))
        return torch.stack([u, v], dim=-3)


def ring_spectrum(seed, grid, Kd2, k_min, k_max):
    """Random-phase PV spectrum (numpy complex128, rfft2 layout): each mode
    (k, l) with k_min^2 < k^2 + l^2 <= k_max^2 contributes
    -(Kd2 + K^2) cos(k x + l y + phi_kl), phases from
    numpy.random.default_rng(seed) (swraytracing_torch/models/qg.py,
    initial_q_ring, before its normalisation)."""
    rng = np.random.default_rng(int(seed))
    phases = rng.uniform(0, 2 * np.pi, (2 * k_max + 1, 2 * k_max + 1))
    qk = np.zeros((grid.nx, grid.nky), dtype=np.complex128)
    scale = 2.0 * np.pi / grid.L
    for k in range(-k_max, k_max + 1):
        for l in range(-k_max, k_max + 1):
            K2i = k * k + l * l
            if not (k_min ** 2 < K2i <= k_max ** 2):
                continue
            if abs(k) > grid.kmax or abs(l) > grid.kmax:
                continue
            c = 0.5 * -(Kd2 + K2i * scale ** 2) * np.exp(
                1j * phases[k + k_max, l + k_max])
            if l > 0:
                qk[k % grid.nx, l] += c
            elif l < 0:
                qk[(-k) % grid.nx, -l] += np.conj(c)
            else:
                qk[k % grid.nx, 0] += c
                qk[(-k) % grid.nx, 0] += np.conj(c)
    return qk * grid.mask_np
