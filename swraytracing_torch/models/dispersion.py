"""Shallow-water wave dispersion and group velocity.

Counterpart of swraytracing_tpu/models/dispersion.py. Reference:
ray_trace_sw/cg_sw.m (omega = sqrt(f^2 + gH*(k^2+l^2)), C = gH*k/omega,
div C and the grad-omega terms for a geostrophically balanced depth) and
the inline dispersion in ode_symplectic.m:10-11 and qgsw_raytrace.m:262.

qgsw_raytrace.m:262 writes the group velocity as Cg*k/omega rather than
Cg^2*k/omega; with the production value Cg = 1 the two coincide. This is
the correct Cg^2*k/omega = d(omega)/dk.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Dispersion"]


class Dispersion(NamedTuple):
    """Near-inertial SW dispersion omega(k) = sqrt(f^2 + Cg^2 |k|^2).

    Attributes:
      f: Coriolis parameter.
      Cg: gravity-wave speed sqrt(g*H0).
    """

    f: float
    Cg: float

    @property
    def gH(self):
        return self.Cg**2

    def omega(self, k: torch.Tensor) -> torch.Tensor:
        """Intrinsic frequency; k: (2, ...) coordinate-first."""
        K2 = torch.sum(k * k, dim=0)
        return torch.sqrt(self.f**2 + self.gH * K2)

    def omega_depth(self, k: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
        """Intrinsic frequency with local depth factor H = 1 + eta_g
        (cg_sw.m:15-22)."""
        K2 = torch.sum(k * k, dim=0)
        return torch.sqrt(self.f**2 + self.gH * H * K2)

    def group_velocity(self, k: torch.Tensor) -> torch.Tensor:
        """C = Cg^2 * k / omega; k: (2, ...) -> (2, ...)."""
        return self.gH * k / self.omega(k)[None]

    def group_velocity_depth(self, k: torch.Tensor, H: torch.Tensor
                             ) -> torch.Tensor:
        """C = gH k / omega with the local depth factor H (...,)."""
        gH = self.gH * H
        K2 = torch.sum(k * k, dim=0)
        om = torch.sqrt(self.f**2 + gH * K2)
        return gH[None] * k / om[None]

    def absolute_frequency(self, k: torch.Tensor, u: torch.Tensor
                           ) -> torch.Tensor:
        """Omega_abs = omega(k) + U . k, the ray invariant in steady flow
        (SW_zero_background_raytracing.m:85-132 uses its conservation as
        the integrator-correctness metric). k, u: (2, ...)."""
        return self.omega(k) + torch.sum(u * k, dim=0)

    def div_group_velocity(self, k, u, v, H=None):
        """div C and grad omega for geostrophically balanced depth
        H = 1 + eta_g, per cg_sw.m:28-32.

        Returns (divC, domega_dx, domega_dy), each (...,).
        """
        kk, ll = k[0], k[1]
        K2 = torch.sum(k * k, dim=0)
        om = self.omega_depth(k, H) if H is not None else self.omega(k)
        gH = self.gH * H if H is not None else self.gH
        cx = gH * kk / om
        cy = gH * ll / om
        divC = (kk * self.f * v - ll * self.f * u - cx**2 - cy**2) / om
        domega_dx = self.f * K2 * v / (2.0 * om)
        domega_dy = -self.f * K2 * u / (2.0 * om)
        return divC, domega_dx, domega_dy
