"""One-layer quasi-geostrophic pseudo-spectral solver.

Counterpart of swraytracing_tpu/models/qg.py (the solver inlined in
qgsw_raytrace.m):
  * PV inversion psi_k = -q_k / (K_d^2 + K^2)            (:271)
  * pseudo-spectral Jacobian                              (:272-283)
  * AB3 time stepping with forward-Euler / AB2 bootstrap  (:121-136)
  * exponential spectral filter applied every step        (:137, :222-230)
  * beta, linear drag, inertial-ring surface forcing      (:285, :216-220)
  * random-phase ring initial PV normalised to max speed  (:191-214)

The state keeps `t` and `step` on the host (Python float and int), as the
two-layer solver does: the Euler / AB2 / AB3 choice is a Python branch and
costs no device synchronisation. An ensemble's state (parallel/ensemble.py)
has a leading member axis on its spectra and keeps each member's `t` and
`step` in host numpy arrays (float64 and int64); `qg_step` then takes each
member's dt and picks each member's Euler / AB2 / AB3 formula on the host.
The static forcing and the per-step filter are host numpy arrays on
`QGParams`; the stepping functions use its cached device view, so no step
uploads them.

Reference quirks and how they are treated:
  * qgsw_raytrace.m:285 adds `r_drag*K2` and the forcing as *constants*
    (missing `.*qk`), i.e. a static spectral forcing rather than drag; and
    the Jacobian enters with a reversed advection sign relative to
    u = -psi_y, v = psi_x. `reference_quirks=True` reproduces both exactly,
    including the fact that the literal committed RHS is violently
    unstable. The default implements the evidently intended physics
    q_t + J(psi, q) + beta v = forcing - r_drag * zeta.
  * `initial_q_ring`'s chained comparison `k_min^2 < K2 <= k_max^2`
    (qgsw_raytrace.m:202) is always true in MATLAB, so the reference's
    "ring" actually fills the whole square |k|,|l| <= k_max; pass
    `ring=False` to reproduce that.

`simulate_qg_particles` advects passive particles with the RSW solvers'
RK4 scheme (models/rsw.advect_particles) in the post-step geostrophic
velocity.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops.grid import (SpectralGrid, complex_dtype, host_array_tensor,
                        resolve_device)
from ..ops import spectral as sp

__all__ = [
    "QGParams",
    "QGState",
    "qg_rhs",
    "qg_init",
    "qg_step",
    "simulate_qg",
    "simulate_qg_particles",
    "initial_q_ring",
    "inertial_ring_forcing",
    "max_speed",
]


class QGParamTensors(NamedTuple):
    """Device view of a QGParams' arrays (None where the array is None)."""

    forcing: torch.Tensor | None   # (nx, nky) real
    filter: torch.Tensor | None    # (nx, nky) real


@dataclasses.dataclass(frozen=True, eq=False)
class QGParams:
    """Solver parameters. `forcing` and `filter` are host numpy arrays;
    `tensors(device, dtype)` is the cached device view the stepping
    functions use."""

    Kd2: float                  # deformation wavenumber squared, f/Cg in ref
    beta: float = 0.0
    r_drag: float = 0.1
    dt: float = 1e-3
    forcing: np.ndarray | None = None   # (nx, nky) static spectral forcing
    filter: np.ndarray | None = None    # (nx, nky) per-step spectral filter
    dealias: bool = False               # reference uses no dealiasing
    reference_quirks: bool = False
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    def tensors(self, device, dtype: torch.dtype) -> QGParamTensors:
        key = (torch.device(device), dtype)
        hit = self._cache.get(key)
        if hit is None:
            def real(a):
                return None if a is None else torch.as_tensor(
                    np.asarray(a), dtype=dtype, device=key[0])

            hit = QGParamTensors(forcing=real(self.forcing),
                                 filter=real(self.filter))
            self._cache[key] = hit
        return hit


@dataclasses.dataclass
class QGState:
    qk: torch.Tensor        # (nx, nky) complex PV spectrum
    rhs_m1: torch.Tensor    # previous RHS (AB history)
    rhs_m2: torch.Tensor    # RHS two steps back
    t: float                # host scalar; (E,) float64 numpy for members
    step: int               # host scalar; (E,) int64 numpy for members


def _psik(qk, grid: SpectralGrid, Kd2):
    denom = Kd2 + grid.tensors(qk.device, sp._real_dtype(qk)).K2
    denom = torch.where(denom == 0, 1.0, denom)
    return -qk / denom


def qg_rhs(qk, grid: SpectralGrid, p: QGParams):
    """dq_k/dt. See the module docstring for the quirks switch."""
    rd = sp._real_dtype(qk)
    K2 = grid.tensors(qk.device, rd).K2
    psik = _psik(qk, grid, p.Kd2)
    Jk = sp.dealiased_jacobian(psik, qk, grid, dealias=p.dealias)
    beta_term = p.beta * sp.ddx(psik, grid)
    if p.reference_quirks:
        # qgsw_raytrace.m:285 verbatim: dq = J - beta*psikx + r*K2 + F
        dq = Jk - beta_term + p.r_drag * K2.to(qk.dtype)
    else:
        # q_t = -J(psi,q) - beta psi_x - r_drag * zeta,  zeta_k = -K2 psi_k
        drag = p.r_drag * K2 * psik
        dq = -Jk - beta_term + drag
    forcing = p.tensors(qk.device, rd).forcing
    if forcing is not None:
        dq = dq + forcing
    return dq


def qg_init(qk0: torch.Tensor, t0: float = 0.0) -> QGState:
    z = torch.zeros_like(qk0)
    return QGState(qk=qk0, rhs_m1=z, rhs_m2=z, t=float(t0), step=0)


def qg_step(state: QGState, grid: SpectralGrid, p: QGParams,
            dt=None) -> QGState:
    """One AB3 step with Euler/AB2 bootstrap (qgsw_raytrace.m:121-137),
    then the spectral filter. Returns a new state; the input is not
    modified.

    An ensemble's state ((E, nx, nky) spectra, host arrays `t` and `step`)
    takes `dt`, each member's step as an (E,) host array (0 steps a frozen
    member with dt = 0; see _qg_step_members); a single state steps by
    p.dt."""
    if isinstance(state.step, np.ndarray):
        return _qg_step_members(state, grid, p, np.asarray(dt, np.float64))
    Qn = qg_rhs(state.qk, grid, p)
    dt = p.dt
    if state.step == 0:
        dq = dt * Qn
    elif state.step == 1:
        dq = dt / 2.0 * (3.0 * Qn - state.rhs_m1)
    else:
        dq = dt / 12.0 * (23.0 * Qn - 16.0 * state.rhs_m1
                          + 5.0 * state.rhs_m2)
    qk = state.qk + dq
    filt = p.tensors(qk.device, sp._real_dtype(qk)).filter
    if filt is not None:
        qk = qk * filt
    return QGState(qk=qk, rhs_m1=Qn, rhs_m2=state.rhs_m1,
                   t=state.t + dt, step=state.step + 1)


# Coefficient of the right-hand sides in the Euler, AB2 and AB3 updates,
# as a multiple of dt (the factors qg_step applies to dt on the host).
_AB_DT_FACTOR = (1.0, 2.0, 12.0)


def _qg_step_members(state: QGState, grid: SpectralGrid, p: QGParams,
                     dt: np.ndarray) -> QGState:
    """qg_step over an ensemble's members, each with its own dt and its
    own Euler / AB2 / AB3 formula, min(step, 2), as the JAX package picks
    it per member (lax.switch under vmap). Each formula that some member
    uses is evaluated on all members, with its coefficient dt / 1, 2 or 12
    formed on the host in float64 and rounded once to the state's real
    type, as the single-member step rounds it; the members then take
    their own formula's result. The filter and the forcing are shared.
    Every per-member tensor comes from host_array_tensor, so once the
    members' dt and formulas repeat a step copies nothing to the device.
    `t` advances by dt and `step` by 1 on the host, for every member: the
    caller restores a frozen member's."""
    qk = state.qk
    rd = sp._real_dtype(qk)
    dev = qk.device
    E = qk.shape[0]
    Qn = qg_rhs(qk, grid, p)
    branch = np.minimum(state.step, 2)
    live = dt != 0.0
    # the formulas live members need (all of them when no member is live)
    used = sorted(set(branch[live].tolist()) or set(branch.tolist()))
    dq = None
    for b in used:
        coef = host_array_tensor(dt / _AB_DT_FACTOR[b], rd,
                                 dev).reshape(E, 1, 1)
        if b == 0:
            term = coef * Qn
        elif b == 1:
            term = coef * (3.0 * Qn - state.rhs_m1)
        else:
            term = coef * (23.0 * Qn - 16.0 * state.rhs_m1
                           + 5.0 * state.rhs_m2)
        if dq is None:
            dq = term
        else:
            mine = host_array_tensor(branch == b, torch.bool,
                                     dev).reshape(E, 1, 1)
            dq = torch.where(mine, term, dq)
    qk = qk + dq
    filt = p.tensors(dev, rd).filter
    if filt is not None:
        qk = qk * filt
    return QGState(qk=qk, rhs_m1=Qn, rhs_m2=state.rhs_m1,
                   t=state.t + dt, step=state.step + 1)


def simulate_qg(state: QGState, grid: SpectralGrid, p: QGParams,
                nsteps: int, save_every: int = 1):
    """Run nsteps, saving the PV spectrum every save_every steps. Returns
    (final_state, qk_frames (nframes, nx, nky), t_frames (nframes,)
    float64 on the host)."""
    nframes = nsteps // save_every
    qks, ts = [], []
    for _ in range(nframes):
        for _ in range(save_every):
            state = qg_step(state, grid, p)
        qks.append(state.qk)
        ts.append(state.t)
    qk_frames = (torch.stack(qks) if qks
                 else state.qk.new_zeros((0,) + state.qk.shape))
    return state, qk_frames, torch.tensor(ts, dtype=torch.float64)


def simulate_qg_particles(state: QGState, xp, grid: SpectralGrid,
                          p: QGParams, nsteps: int, save_every: int = 1):
    """QG flow + passive Lagrangian particles advected by the
    geostrophic velocity — the experiment of the reference's
    pyqgParticleAdvection.ipynb notebook (pyqg QGModel + particle
    cloud), and the particle option of the RSW solvers
    (rsw/swk.m:184-186), on this solver. Each flow step is qg_step, then
    the (u, v) grids of fields.flow_from_qk, then one RK4
    rsw.advect_particles step in them (frozen over the step, like
    rsw/advect1d.m). Runs on the device of the state.

    Args:
      xp: (2, Np) particle positions, coordinate-first, on the state's
        device in its real dtype.
    Returns:
      (final_state, xp_final, xp_frames (nframes, 2, Np), t_frames
      (nframes,) float64 on the host).
    """
    from .fields import flow_from_qk
    from .rsw import advect_particles

    nframes = nsteps // save_every
    xs, ts = [], []
    for _ in range(nframes):
        for _ in range(save_every):
            state = qg_step(state, grid, p)
            uv = flow_from_qk(state.qk, grid, p.Kd2, n_fields=2).fields
            xp = advect_particles(xp, uv[0], uv[1], grid, p.dt)
        xs.append(xp)
        ts.append(state.t)
    xp_frames = torch.stack(xs) if xs else xp.new_zeros((0,) + xp.shape)
    return state, xp, xp_frames, torch.tensor(ts, dtype=torch.float64)


# ---------------------------------------------------------------------------
# Initial conditions and forcing
# ---------------------------------------------------------------------------


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
