"""Shallow-water wave dispersion and group velocity.

Counterpart of swraytracing_tpu/models/dispersion.py. Reference:
ray_trace_sw/cg_sw.m (omega = sqrt(f^2 + gH*(k^2+l^2)), C = gH*k/omega)
and the inline dispersion in ode_symplectic.m:10-11 and
qgsw_raytrace.m:262.

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

    def group_velocity(self, k: torch.Tensor) -> torch.Tensor:
        """C = Cg^2 * k / omega; k: (2, ...) -> (2, ...)."""
        return self.gH * k / self.omega(k)[None]

    def absolute_frequency(self, k: torch.Tensor, u: torch.Tensor
                           ) -> torch.Tensor:
        """Omega_abs = omega(k) + U . k, the ray invariant in steady flow
        (SW_zero_background_raytracing.m:85-132 uses its conservation as
        the integrator-correctness metric). k, u: (2, ...)."""
        return self.omega(k) + torch.sum(u * k, dim=0)
