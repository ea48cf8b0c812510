"""One-layer QG, plain (qgsw_raytrace.m), over a batch of members.

Copied from swraytracing_torch/models/qg.py, ops/spectral.exp_filter and
models/coupled.setup_coupled (commit 701921e): psi_k = -q_k/(Kd2 + K^2);
q_t = -J(psi, q) - beta psi_x + r_drag K^2 psi_k + forcing (the forcing
on near-inertial modes, 0.9 f < omega < 1.1 f); AB3 with an Euler and an
AB2 start, then the exponential filter every step; the ring IC (modes
5 < |k| <= 8) normalised to max speed U_g; dt = CFL_fraction * dx / U0.
Each member (leading axis) has its own dt.
"""

import numpy as np
import torch

from . import exact
from .spectral import Grid, ring_spectrum


class QG:
    """One-layer operators of a configuration (a dict of its keys)."""

    def __init__(self, cfg, device, dtype=torch.float64):
        self.cfg = cfg
        self.f, self.Cg = cfg["f"], cfg["Cg"]
        self.Kd2 = cfg["f"] / cfg["Cg"]
        self.grid = g = Grid(cfg["nx"], cfg["L"], device, dtype)
        ikx = np.fft.fftfreq(g.nx, 1.0 / g.nx)[:, None]
        iky = np.arange(g.nky)[None, :]
        kstar = np.sqrt((ikx * 2 * np.pi / g.nx) ** 2
                        + (iky * 2 * np.pi / g.ny) ** 2)
        cut, width = 0.75 * np.pi, 0.25 * np.pi
        filt = np.where(kstar >= cut, np.exp(np.log(1e-15) / width ** 4
                                             * (kstar - cut) ** 4), 1.0)
        self.filter = g.t(filt * g.mask_np)
        omega = np.sqrt(self.f ** 2 + self.Cg ** 2 * g.K2_np)
        force = np.where((0.9 * self.f < omega) & (omega < 1.1 * self.f),
                         cfg["forcing_strength"], 0.0)
        self.forcing = g.t(force * g.mask_np)
        den = self.Kd2 + g.K2_np
        self.inv = g.t(-1.0 / np.where(den == 0, 1.0, den))

    def psik(self, qk):
        return qk * self.inv

    def rhs(self, qk):
        g, cfg = self.grid, self.cfg
        psik = self.psik(qk)
        return (-g.jacobian(psik, qk) - cfg["beta"] * g.ddx(psik)
                + cfg["r_drag"] * g.K2 * psik + self.forcing)

    def step(self, qk, r1, r2, n, dt, rnd=exact):
        """One AB3 step of every member: qk (E, nx, nky), step counts n
        (E,) ints, dt (E,) floats: Euler at step 0, AB2 at 1, AB3 after.
        Returns (qk, rhs, r1)."""
        Q = self.rhs(qk)
        n, dt = np.asarray(n), np.asarray(dt, np.float64)
        a = np.where(n == 0, dt, np.where(n == 1, 1.5 * dt, 23 / 12 * dt))
        b = np.where(n == 0, 0.0, np.where(n == 1, -0.5 * dt, -16 / 12 * dt))
        c = np.where(n >= 2, 5 / 12 * dt, 0.0)
        coef = self.grid.t(np.stack([a, b, c]))[..., None, None]
        dq = coef[0] * Q + coef[1] * r1 + coef[2] * r2
        return rnd((qk + dq) * self.filter), rnd(Q), r1

    def velocity(self, qk, rnd=exact):
        """(E, 2, nx, ny) velocity grids of each member's flow."""
        return rnd(self.grid.velocity(self.psik(qk)))

    def max_speed(self, qk):
        uv = self.grid.velocity(self.psik(qk))
        return torch.sqrt(torch.max((uv * uv).sum(0)))

    def initial(self, seed, U_g, rnd=exact):
        """(qk0 (nx, nky), U0, dt) of one member."""
        g = self.grid
        q = g.t(ring_spectrum(seed, g, self.Kd2, 5, 8),
                torch.complex128 if g.dtype == torch.float64
                else torch.complex64)
        q = rnd(q * (U_g / self.max_speed(q)))
        U0 = float(self.max_speed(q))
        return q, U0, self.cfg["CFL_fraction"] * g.dx / U0
