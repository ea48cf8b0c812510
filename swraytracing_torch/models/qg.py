"""One-layer quasi-geostrophic building blocks.

Counterpart of the initial-condition, inversion and diagnostic functions
of swraytracing_tpu/models/qg.py (the solver inlined in
qgsw_raytrace.m): PV inversion psi_k = -q_k / (K_d^2 + K^2) (:271), the
random-phase ring initial PV normalised to a maximum speed (:191-214),
and the inertial-ring forcing mask (:216-220). The one-layer time stepper
itself (`qg_step`, with forcing and the exponential filter) is not part
of this module yet; the two-layer solver (qg2.py) shares
`initial_q_ring`.

`initial_q_ring`'s chained comparison `k_min^2 < K2 <= k_max^2`
(qgsw_raytrace.m:202) is always true in MATLAB, so the reference's "ring"
actually fills the whole square |k|,|l| <= k_max; pass `ring=False` to
reproduce that.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.grid import SpectralGrid, complex_dtype, resolve_device
from ..ops import spectral as sp

__all__ = ["initial_q_ring", "inertial_ring_forcing", "max_speed"]


def _psik(qk, grid: SpectralGrid, Kd2):
    denom = Kd2 + grid.tensors(qk.device, sp._real_dtype(qk)).K2
    denom = torch.where(denom == 0, 1.0, denom)
    return -qk / denom


def initial_q_ring(seed: int, grid: SpectralGrid, U_g: float, Kd2: float,
                   k_min: int = 5, k_max: int = 8, ring: bool = True, *,
                   device=None, dtype: torch.dtype = torch.float32):
    """Random-phase PV spectrum normalised so max |u| = U_g
    (qgsw_raytrace.m:191-214).

    Each mode (k, l) contributes -(Kd2 + K^2) cos(k x + l y + phi_kl) to
    q. `ring=True` keeps k_min^2 < K^2 <= k_max^2 (the documented intent);
    `ring=False` reproduces the reference's always-true chained comparison
    (every mode in the square, including the mean).

    Wavenumbers are integer multiples of the domain wavenumber 2*pi/L, as
    in the two-layer run (qg2layersw_raytrace.m:19-21). The phases
    come from ``np.random.default_rng(seed)``, so the JAX package draws
    the same ones from the same int seed. The spectrum is assembled on the
    host in float64 and normalised on `device` in `dtype`.
    Returns qk (rfft2 layout), complex.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(int(seed))
    phases = rng.uniform(0, 2 * np.pi, (2 * k_max + 1, 2 * k_max + 1))

    qk = np.zeros(grid.spectral_shape, dtype=np.complex128)
    scale_k = 2.0 * np.pi / grid.Lx  # physical wavenumber per integer mode
    for k in range(-k_max, k_max + 1):
        for l in range(-k_max, k_max + 1):
            K2i = k * k + l * l
            if ring and not (k_min**2 < K2i <= k_max**2):
                continue
            if abs(k) > grid.kmax or abs(l) > grid.kmax:
                continue  # mode not representable on this grid
            phi = phases[k + k_max, l + k_max]
            amp = -(Kd2 + K2i * scale_k**2)
            # cos(kx+ly+phi) -> 0.5 e^{i phi} at (k,l) + conj at (-k,-l)
            c = 0.5 * amp * np.exp(1j * phi)
            if l > 0:
                qk[k % grid.nx, l] += c
            elif l < 0:
                qk[(-k) % grid.nx, -l] += np.conj(c)
            else:  # l == 0: both half-plane slots live in the ky=0 column
                qk[k % grid.nx, 0] += c
                qk[(-k) % grid.nx, 0] += np.conj(c)
    qk *= grid.nyquist_mask

    # Normalise to max speed U_g using the induced geostrophic velocities.
    q = torch.as_tensor(qk, dtype=complex_dtype(dtype), device=device)
    return q * (U_g / max_speed(q, grid, Kd2))


def max_speed(qk, grid: SpectralGrid, Kd2, shear: float = 0.0):
    """max sqrt(u^2 + v^2) of the flow induced by qk (qgsw_raytrace.m:63-66).
    Returns a 0-dim tensor on qk's device."""
    psik = _psik(qk, grid, Kd2)
    u = sp.to_grid(-sp.ddy(psik, grid), grid) + shear
    v = sp.to_grid(sp.ddx(psik, grid), grid)
    return torch.sqrt(torch.max(u * u + v * v))


def inertial_ring_forcing(strength: float, grid: SpectralGrid, f: float,
                          Cg: float) -> np.ndarray:
    """Static spectral forcing on near-inertial modes
    (qgsw_raytrace.m:216-220): strength where 0.9 f < omega < 1.1 f with
    omega = sqrt(f^2 + Cg^2 K^2). Host numpy array (nx, nky)."""
    omega = np.sqrt(f**2 + Cg**2 * grid.K2)
    forces = np.where((0.9 * f < omega) & (omega < 1.1 * f), strength, 0.0)
    return forces * grid.nyquist_mask
