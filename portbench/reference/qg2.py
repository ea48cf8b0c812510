"""Two-layer QG with imposed shear, plain (qg2layersw_raytrace.m).

Copied from swraytracing_torch/models/qg2.py and models/coupled2.py
(commit 701921e): per-mode 2x2 inversion psi = B q with F = Kd2/2; the
linear operator (shear, hyperviscosity, drag, beta) integrated exactly by
per-mode 2x2 matrix exponentials built on the host in float64;
integrating-factor AB3 on the aliased Jacobian (Euler, then AB2, then
AB3); the top layer's velocity with the shear added to u; the ring IC
(q2 = -q1, modes 10 < |k| <= 30) normalised to max speed U_g; and
dt = CFL_fraction/2 * dx / U0 from the IC's max speed over both layers.
"""

import numpy as np
import torch

from . import exact
from .spectral import Grid, ring_spectrum


class QG2:
    """Operators of one two-layer configuration (a dict of the
    configuration's keys) on one grid, and its dt."""

    def __init__(self, cfg, device, dtype=torch.float64):
        self.cfg = cfg
        self.f, self.Cg = cfg["f"], cfg["Cg"]
        self.Kd2 = cfg["f"] / cfg["Cg"]
        self.shear = cfg["shear"]
        self.grid = g = Grid(cfg["nx"], cfg["L"], device, dtype)
        F = self.Kd2 / 2.0
        K2 = g.K2_np
        det = K2 * (K2 + 2.0 * F)
        det = np.where(det == 0.0, np.inf, det)
        B = np.array([[(-F - K2) / det, -F / det], [-F / det, (-F - K2) / det]])
        self.B_np = B
        self.B = g.t(B)
        self.dt = None

    def set_dt(self, dt):
        """Build exp(dt L) and exp(2 dt L) for the time step dt."""
        cfg, g, B = self.cfg, self.grid, self.B_np
        F = self.Kd2 / 2.0
        K2, kx = g.K2_np, g.kx_np
        nu = cfg["nu_tune"] * g.dx ** (2 * cfg["alpha"])
        L = B * ((nu * K2 ** cfg["alpha"] + cfg["r"]) * K2
                 - 1j * kx * cfg["beta"])
        s = 1j * kx * cfg["shear"]
        L[0, 0] += -s * (1.0 + 2.0 * F * B[0, 0])
        L[0, 1] += -s * (2.0 * F * B[0, 1])
        L[1, 0] += s * (2.0 * F * B[1, 0])
        L[1, 1] += s * (1.0 + 2.0 * F * B[1, 1])
        cd = torch.complex128 if g.dtype == torch.float64 else torch.complex64
        self.E1 = g.t(_expm2(L, dt), cd)
        self.E2 = g.t(_expm2(L, 2 * dt), cd)
        self.dt = float(dt)

    def psik(self, qk):
        return self.B[:, 0] * qk[0] + self.B[:, 1] * qk[1]

    def step(self, qk, r1, r2, n, rnd=exact):
        """One IF-AB3 step from step count n; returns (qk, rhs, r1)."""
        g, dt = self.grid, self.dt
        Q = g.jacobian(self.psik(qk), qk)
        if n == 0:
            dq = dt * Q
        elif n == 1:
            dq = dt / 2.0 * (3.0 * Q - _mat(self.E1, r1))
        else:
            dq = dt / 12.0 * (23.0 * Q - 16.0 * _mat(self.E1, r1)
                              + 5.0 * _mat(self.E2, r2))
        return rnd(_mat(self.E1, qk + dq)), rnd(Q), r1

    def velocity(self, qk, rnd=exact):
        """(2, nx, ny) top-layer (u, v), the shear added to u."""
        return rnd(self.grid.velocity(self.psik(qk)[0], self.shear))

    def max_speed(self, qk):
        uv = self.grid.velocity(self.psik(qk))         # (layer, 2, nx, ny)
        u = uv[:, 0].clone()
        u[0] += self.shear
        return torch.sqrt(torch.max(u * u + uv[:, 1] * uv[:, 1]))

    def initial(self, seed, U_g, rnd=exact):
        """(qk0 (2, nx, nky), U0, dt): the ring IC normalised to U_g, its
        max speed and the configuration's time step."""
        g = self.grid
        q = g.t(ring_spectrum(seed, g, self.Kd2, 10, 30),
                torch.complex128 if g.dtype == torch.float64
                else torch.complex64)
        psik = -q / torch.where(self.Kd2 + g.K2 == 0, 1.0, self.Kd2 + g.K2)
        uv = g.velocity(psik)
        q = rnd(q * (U_g / torch.sqrt(torch.max((uv * uv).sum(0)))))
        qk = torch.stack([q, -q])
        U0 = float(self.max_speed(qk))
        dt = 0.5 * self.cfg["CFL_fraction"] * g.dx / U0
        return qk, U0, dt


def _mat(A, x):
    return A[:, 0] * x[0] + A[:, 1] * x[1]


def _expm2(A, t):
    """exp(t A) of per-mode 2x2 matrices A (2, 2, ...), closed form."""
    a, b, c, d = A[0, 0], A[0, 1], A[1, 0], A[1, 1]
    mu = 0.5 * (a + d)
    delta = np.sqrt((0.25 * (a - d) ** 2 + b * c).astype(np.complex128))
    e1, e2 = np.exp(t * (mu + delta)), np.exp(t * (mu - delta))
    c0 = 0.5 * (e1 + e2)
    small = np.abs(t * delta) < 1e-12
    c1 = np.where(small, t * np.exp(t * mu),
                  (e1 - e2) / np.where(small, 1.0, 2.0 * delta))
    return np.array([[c0 + c1 * (a - mu), c1 * b],
                     [c1 * c, c0 + c1 * (d - mu)]])
