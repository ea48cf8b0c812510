"""Two-layer quasi-geostrophic solver with background shear.

Counterpart of swraytracing_tpu/models/qg2.py, the solver inlined in
qg2layersw_raytrace.m:
  * per-mode 2x2 PV inversion psi = B q with F = K_d^2/2
    (qg2layersw_raytrace.m:129-137); B is the closed-form inverse of
    [[-K2-F, F], [F, -K2-F]], zeroed at the mean mode;
  * linear operator L = shear + diffusion/drag/beta terms integrated
    EXACTLY by a per-mode 2x2 matrix exponential (:140-149), in closed
    form, computed once on the host in float64;
  * integrating-factor AB3 on the nonlinear Jacobian with exp-factor
    propagation of the history terms (:168-181): the AB3 history RHS
    values are multiplied by exp(dt L) / exp(2 dt L) before combining,
    and the update is qk <- exp(dt L) (qk + dq);
  * nonlinear term: per-layer pseudo-spectral Jacobian, same reversed
    advection sign as the one-layer solver (:309-323), optional
    dealiasing (the reference has none).

The reference adapts dt when the CFL check fails and rebuilds the
exponential operators (:154-165). Here dt is fixed per `QG2Operators`;
`build_operators` is cheap, so an outer loop can re-chunk with a new dt.

The state keeps `t` and `step` on the host (Python float and int): the
Euler / AB2 / AB3 choice is then a Python branch and costs no device
synchronisation.

Reference quirks handled:
  * the two-layer initial_q (:258-281) builds cos(k*X + l*Y) with INTEGER
    k,l on the L=20 domain, which is not periodic on the domain;
    `initial_q2_ring` seeds the ring in spectral space with physical
    wavenumbers 2*pi*k/L (pass ring=False for the reference's always-true
    chained comparison);
  * packet advection "with the top layer" (:185-189) actually calls the
    ONE-layer inversion psik = -qk/(K_d2+K2) (grid_U.m:2);
    `top_layer_flow` implements the intended physics (top layer of the
    true 2x2 inversion); `one_layer_quirk=True` reproduces the
    reference's evaluation.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops.grid import SpectralGrid, complex_dtype
from ..ops import spectral as sp
from .fields import GriddedFlow, _stack_from_psik
from .qg import initial_q_ring

__all__ = [
    "QG2Params",
    "QG2Operators",
    "QG2State",
    "build_operators",
    "qg2_init",
    "qg2_rhs",
    "qg2_step",
    "simulate_qg2",
    "initial_q2_ring",
    "top_layer_flow",
    "max_speed2",
]


class QG2Params(NamedTuple):
    """Physical/tuning parameters (qg2layersw_raytrace.m:24-34)."""

    Kd2: float                 # deformation wavenumber^2; F = Kd2/2
    shear: float = 0.5         # imposed vertical shear (shear_strength)
    beta: float = 0.0
    r: float = 0.4             # linear drag
    nu_tune: float = 0.1       # nu = nu_tune * dx^(2*alpha)
    alpha: int = 4             # hyperviscosity order
    dealias: bool = False      # reference Jacobian is aliased


class OperatorTensors(NamedTuple):
    """Device view of a QG2Operators."""

    B: torch.Tensor          # (2, 2, nx, nky) real
    expLdt: torch.Tensor     # (2, 2, nx, nky) complex
    expL2dt: torch.Tensor    # (2, 2, nx, nky) complex


@dataclasses.dataclass(frozen=True, eq=False)
class QG2Operators:
    """Static per-mode operator arrays, built host-side (numpy, float64 /
    complex128) per (grid, dt). `tensors(device, dtype)` is the cached
    device view the stepping functions use."""

    B: np.ndarray          # (2, 2, nx, nky) inversion matrix (real)
    expLdt: np.ndarray     # (2, 2, nx, nky) complex exp(dt L)
    expL2dt: np.ndarray    # (2, 2, nx, nky) complex exp(2 dt L)
    dt: float
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    def tensors(self, device, dtype: torch.dtype) -> OperatorTensors:
        key = (torch.device(device), dtype)
        hit = self._cache.get(key)
        if hit is None:
            cd = complex_dtype(dtype)
            hit = OperatorTensors(
                B=torch.as_tensor(self.B, dtype=dtype, device=key[0]),
                expLdt=torch.as_tensor(self.expLdt, dtype=cd, device=key[0]),
                expL2dt=torch.as_tensor(self.expL2dt, dtype=cd,
                                        device=key[0]))
            self._cache[key] = hit
        return hit


@dataclasses.dataclass
class QG2State:
    qk: torch.Tensor        # (2, nx, nky) complex PV spectra
    rhs_m1: torch.Tensor    # AB history
    rhs_m2: torch.Tensor
    t: float                # host scalar
    step: int               # host scalar


def _ops_t(ops: QG2Operators, x: torch.Tensor) -> OperatorTensors:
    return ops.tensors(x.device, sp._real_dtype(x))


# ---------------------------------------------------------------------------
# Operator construction (host-side, float64)
# ---------------------------------------------------------------------------

def _inversion_matrix(grid: SpectralGrid, Kd2: float) -> np.ndarray:
    """B with psi = B q; the closed-form 2x2 inverse of the coupling
    matrix, matching qg2layersw_raytrace.m:129-137 (zero at K2=0)."""
    F = Kd2 / 2.0
    K2 = grid.K2
    det = K2 * (K2 + 2.0 * F)
    det = np.where(det == 0.0, np.inf, det)
    B = np.empty((2, 2) + K2.shape)
    B[0, 0] = (-F - K2) / det
    B[0, 1] = -F / det
    B[1, 0] = -F / det
    B[1, 1] = (-F - K2) / det
    return B


def _expm2(A: np.ndarray, t: float) -> np.ndarray:
    """Closed-form exp(t*A) for per-mode 2x2 matrices A (2,2,...).

    Eigenvalue form: with mu = tr/2, delta = sqrt((a-d)^2/4 + bc), the
    eigenvalues are mu +- delta and
      exp(tA) = c0 I + c1 (A - mu I),
      c0 = (e^{t l1} + e^{t l2})/2, c1 = (e^{t l1} - e^{t l2})/(2 delta),
    which stays finite for strongly damped modes (the naive
    e^{t mu} cosh(t delta) form is 0 * inf there)."""
    a, b, c, d = A[0, 0], A[0, 1], A[1, 0], A[1, 1]
    mu = 0.5 * (a + d)
    delta = np.sqrt((0.25 * (a - d) ** 2 + b * c).astype(np.complex128))
    e1 = np.exp(t * (mu + delta))
    e2 = np.exp(t * (mu - delta))
    c0 = 0.5 * (e1 + e2)
    small = np.abs(t * delta) < 1e-12
    denom = np.where(small, 1.0, 2.0 * delta)
    c1 = np.where(small, t * np.exp(t * mu), (e1 - e2) / denom)
    E = np.empty(np.broadcast_shapes(A.shape, (2, 2) + mu.shape),
                 dtype=np.complex128)
    E[0, 0] = c0 + c1 * (a - mu)
    E[0, 1] = c1 * b
    E[1, 0] = c1 * c
    E[1, 1] = c0 + c1 * (d - mu)
    return E


def build_operators(grid: SpectralGrid, p: QG2Params, dt: float
                    ) -> QG2Operators:
    """B, exp(dt L), exp(2 dt L) per qg2layersw_raytrace.m:129-149."""
    F = p.Kd2 / 2.0
    K2 = grid.K2
    kx = grid.kx  # (nx, 1) physical wavenumbers
    nu = p.nu_tune * grid.dx ** (2 * p.alpha)
    B = _inversion_matrix(grid, p.Kd2)

    diffusion_factor = ((nu * K2**p.alpha + p.r) * K2
                        - 1j * kx * p.beta)            # (nx, nky) complex
    diffusion = B * diffusion_factor                   # scalar * 2x2

    # mean_flow_terms = i kx shear * diag(-1, 1) @ (I + 2F B)
    M = np.zeros((2, 2) + K2.shape, dtype=np.complex128)
    eye2FB = np.empty_like(B)
    eye2FB[0, 0] = 1.0 + 2.0 * F * B[0, 0]
    eye2FB[0, 1] = 2.0 * F * B[0, 1]
    eye2FB[1, 0] = 2.0 * F * B[1, 0]
    eye2FB[1, 1] = 1.0 + 2.0 * F * B[1, 1]
    shear_factor = 1j * kx * p.shear
    M[0] = -shear_factor * eye2FB[0]
    M[1] = +shear_factor * eye2FB[1]

    L = M + diffusion
    return QG2Operators(B=B, expLdt=_expm2(L, dt), expL2dt=_expm2(L, 2 * dt),
                        dt=float(dt))


# ---------------------------------------------------------------------------
# RHS and stepping
# ---------------------------------------------------------------------------

def _mat2(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-mode 2x2 matrix times 2-vector of spectra: (2,2,nx,nky) x
    (2,nx,nky) -> (2,nx,nky). Reference mmult3 (:333-338)."""
    return A[:, 0] * x[0] + A[:, 1] * x[1]


def qg2_rhs(qk, grid: SpectralGrid, ops: QG2Operators, p: QG2Params):
    """Nonlinear term: per-layer Jacobian with the reference's sign
    (qg2layersw_raytrace.m:309-323)."""
    psik = _mat2(_ops_t(ops, qk).B, qk)
    return sp.dealiased_jacobian(psik, qk, grid, dealias=p.dealias)


def qg2_init(qk0: torch.Tensor, t0: float = 0.0) -> QG2State:
    z = torch.zeros_like(qk0)
    return QG2State(qk=qk0, rhs_m1=z, rhs_m2=z, t=float(t0), step=0)


def qg2_step(state: QG2State, grid: SpectralGrid, ops: QG2Operators,
             p: QG2Params) -> QG2State:
    """One integrating-factor AB3 step (qg2layersw_raytrace.m:168-181):
    history RHS terms are propagated by exp(dt L)/exp(2 dt L), and the
    combined update is qk <- exp(dt L)(qk + dq). Euler on the first step,
    AB2 on the second. Returns a new state; the input is not modified."""
    Qn = qg2_rhs(state.qk, grid, ops, p)
    dt = ops.dt
    o = _ops_t(ops, state.qk)
    if state.step == 0:
        dq = dt * Qn
    elif state.step == 1:
        dq = dt / 2.0 * (3.0 * Qn - _mat2(o.expLdt, state.rhs_m1))
    else:
        dq = dt / 12.0 * (23.0 * Qn
                          - 16.0 * _mat2(o.expLdt, state.rhs_m1)
                          + 5.0 * _mat2(o.expL2dt, state.rhs_m2))
    qk = _mat2(o.expLdt, state.qk + dq)
    return QG2State(qk=qk, rhs_m1=Qn, rhs_m2=state.rhs_m1,
                    t=state.t + dt, step=state.step + 1)


def simulate_qg2(state: QG2State, grid: SpectralGrid, ops: QG2Operators,
                 p: QG2Params, nsteps: int, save_every: int = 1):
    """Run nsteps, saving the PV spectra every save_every steps. Returns
    (final_state, qk_frames (nframes, 2, nx, nky), t_frames (nframes,)
    float64 on the host)."""
    nframes = nsteps // save_every
    qks, ts = [], []
    for _ in range(nframes):
        for _ in range(save_every):
            state = qg2_step(state, grid, ops, p)
        qks.append(state.qk)
        ts.append(state.t)
    qk_frames = (torch.stack(qks) if qks
                 else state.qk.new_zeros((0,) + state.qk.shape))
    return state, qk_frames, torch.tensor(ts, dtype=torch.float64)


# ---------------------------------------------------------------------------
# Flow evaluation and diagnostics
# ---------------------------------------------------------------------------

def top_layer_flow(qk, grid: SpectralGrid, ops: QG2Operators, p: QG2Params,
                   one_layer_quirk: bool = False,
                   n_fields: int = 6) -> GriddedFlow:
    """Velocity/gradient grids of the top layer for packet advection
    (qg2layersw_raytrace.m:185-189). Default: top layer of the true 2x2
    inversion + imposed shear. one_layer_quirk=True reproduces the
    reference's accidental one-layer inversion psik = -qk1/(K_d2+K2).
    n_fields=2: only (u, v) — see fields._stack_from_psik."""
    if one_layer_quirk:
        denom = p.Kd2 + grid.tensors(qk.device, sp._real_dtype(qk)).K2
        psik_top = -qk[0] / torch.where(denom == 0, 1.0, denom)
    else:
        psik_top = _mat2(_ops_t(ops, qk).B, qk)[0]
    return GriddedFlow(
        fields=_stack_from_psik(psik_top, grid, p.shear, n_fields),
        grid=grid)


def max_speed2(qk, grid: SpectralGrid, ops: QG2Operators, p: QG2Params):
    """max speed over BOTH layers incl. shear on the top layer
    (qg2layersw_raytrace.m:157-159; grid_U adds shear to every layer's u
    there — here it is added to the top layer only, matching the physics).
    Returns a 0-dim tensor on qk's device."""
    psik = _mat2(_ops_t(ops, qk).B, qk)
    u = sp.to_grid(-sp.ddy(psik, grid), grid)
    v = sp.to_grid(sp.ddx(psik, grid), grid)
    u[0] += p.shear  # in place: `u` is this function's own
    return torch.sqrt(torch.max(u * u + v * v))


def initial_q2_ring(seed: int, grid: SpectralGrid, U_g: float, Kd2: float,
                    k_min: int = 10, k_max: int = 30, ring: bool = True, *,
                    device=None, dtype: torch.dtype = torch.float32):
    """Two-layer PV IC: q2 = -q1 with q1 a random-phase ring normalised
    to max speed U_g (qg2layersw_raytrace.m:57-59, 258-281).

    Seeded in spectral space with physical wavenumbers (periodic on the
    domain), unlike the reference's integer-wavenumber cos() sum which is
    non-periodic on its L=20 box.
    """
    q1k = initial_q_ring(seed, grid, U_g, Kd2, k_min=k_min, k_max=k_max,
                         ring=ring, device=device, dtype=dtype)
    return torch.stack([q1k, -q1k])
