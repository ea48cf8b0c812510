"""Ray integrators for wave-packet tracing.

Counterpart of swraytracing_tpu/models/rays.py, vectorised over packets:
  * symplectic Strang splitting phi1(dt/2) o phi2(dt) o phi1(dt/2)
    (ode_symplectic.m:13-37) plus the 4th-order Yoshida composition the
    reference sketches but never wires up (ode_symplectic.m:39-53);
  * coupled RK4 / fixed-step RK23 on the full ray RHS
    dx/dt = U + Cg^2 k/omega, dk/dt = -(grad U)^T k with time-blended
    flow snapshots — the production ode23 path
    (qg_flow_ray_trace/qgsw_raytrace.m:258-268); rk23_step uses the same
    Bogacki–Shampine stages at fixed step.

All packets advance in one batched update; there is no per-packet loop.
Everything is differentiable end to end through autograd. A `flow` is any
object with `.at(x, y, alpha) -> FlowEval` (models/fields.py).

The adaptive integrator (`rk23_adaptive`) and the frozen-coefficient
steppers (`rk4_frozen_step`, `rk4_xka_step`) are not part of this module
yet.
"""

from __future__ import annotations

from typing import Callable

import torch

from .dispersion import Dispersion

__all__ = [
    "ray_rhs",
    "symplectic_step",
    "yoshida4_step",
    "rk4_step",
    "rk23_step",
    "integrate_rays",
]


# ---------------------------------------------------------------------------
# RHS
# ---------------------------------------------------------------------------

def ray_rhs(x, k, alpha, disp: Dispersion, flow):
    """Full ray RHS (qgsw_raytrace.m:260-264):
    dx/dt = U(x) + Cg^2 k / omega(k); dk/dt = -(grad U)^T k.
    x, k are (2, Np) coordinate-first."""
    ev = flow.at(x[0], x[1], alpha)
    dx = ev.uv + disp.group_velocity(k)
    dk = -ev.refraction(k)
    return dx, dk


# ---------------------------------------------------------------------------
# Symplectic splitting
# ---------------------------------------------------------------------------

def _phi1(x, k, dt, disp):
    """Free-wave drift: x += dt * C(k), k frozen (ode_symplectic.m:13-16)."""
    return x + dt * disp.group_velocity(k), k


def _phi2(x, k, dt, disp, flow, alpha):
    """Flow kick: x += dt U(x); k -= dt (grad U)^T k, both evaluated at the
    pre-kick position (ode_symplectic.m:18-21)."""
    ev = flow.at(x[0], x[1], alpha)
    return x + dt * ev.uv, k - dt * ev.refraction(k)


def symplectic_step(x, k, dt, disp: Dispersion, flow, alpha=0.0):
    """Strang leapfrog phi1(dt/2) o phi2(dt) o phi1(dt/2)
    (ode_symplectic.m:33-37)."""
    x, k = _phi1(x, k, 0.5 * dt, disp)
    x, k = _phi2(x, k, dt, disp, flow, alpha)
    x, k = _phi1(x, k, 0.5 * dt, disp)
    return x, k


_YOSH_CBRT2 = 2.0 ** (1.0 / 3.0)
_YOSH_W0 = -_YOSH_CBRT2 / (2.0 - _YOSH_CBRT2)
_YOSH_W1 = 1.0 / (2.0 - _YOSH_CBRT2)


def yoshida4_step(x, k, dt, disp: Dispersion, flow, alpha=0.0):
    """4th-order Yoshida composition of the Strang splitting — the scheme
    sketched (with a sign slip in w0) at ode_symplectic.m:39-53."""
    for w in (_YOSH_W1, _YOSH_W0, _YOSH_W1):
        x, k = symplectic_step(x, k, w * dt, disp, flow, alpha)
    return x, k


# ---------------------------------------------------------------------------
# Runge–Kutta on the coupled RHS
# ---------------------------------------------------------------------------

def rk4_step(x, k, dt, disp: Dispersion, flow, alpha0=0.0, dalpha=0.0):
    """Classical RK4 on the coupled (x, k) system. `alpha0` is the flow
    blend fraction at the start of this substep and `dalpha` its increment
    over the substep, so stages sample the time-interpolated flow like the
    reference's ode23 RHS does (interpolate_U.m:19-23)."""

    def f(xx, kk, s):
        return ray_rhs(xx, kk, alpha0 + s * dalpha, disp, flow)

    dx1, dk1 = f(x, k, 0.0)
    dx2, dk2 = f(x + 0.5 * dt * dx1, k + 0.5 * dt * dk1, 0.5)
    dx3, dk3 = f(x + 0.5 * dt * dx2, k + 0.5 * dt * dk2, 0.5)
    dx4, dk4 = f(x + dt * dx3, k + dt * dk3, 1.0)
    xn = x + dt / 6.0 * (dx1 + 2 * dx2 + 2 * dx3 + dx4)
    kn = k + dt / 6.0 * (dk1 + 2 * dk2 + 2 * dk3 + dk4)
    return xn, kn


def rk23_step(x, k, dt, disp: Dispersion, flow, alpha0=0.0, dalpha=0.0):
    """One fixed-step Bogacki–Shampine (ode23) step — same stages as
    MATLAB's ode23 used in the production run (qgsw_raytrace.m:149),
    without adaptive error control."""

    def f(xx, kk, s):
        return ray_rhs(xx, kk, alpha0 + s * dalpha, disp, flow)

    dx1, dk1 = f(x, k, 0.0)
    dx2, dk2 = f(x + 0.5 * dt * dx1, k + 0.5 * dt * dk1, 0.5)
    dx3, dk3 = f(x + 0.75 * dt * dx2, k + 0.75 * dt * dk2, 0.75)
    xn = x + dt * (2.0 * dx1 + 3.0 * dx2 + 4.0 * dx3) / 9.0
    kn = k + dt * (2.0 * dk1 + 3.0 * dk2 + 4.0 * dk3) / 9.0
    return xn, kn


# ---------------------------------------------------------------------------
# Integration loop
# ---------------------------------------------------------------------------

def integrate_rays(x0, k0, dt, nsteps, step_fn: Callable, save_every: int = 1,
                   t0: float = 0.0):
    """Integrate rays for `nsteps` steps, saving every `save_every`.

    Args:
      step_fn: (x, k, t) -> (x, k); t is the time at the step start (a
        Python float).
    Returns:
      (x_hist, k_hist, t_hist): (nframes, 2, Np) x2 and (nframes,) float64
      on the host, where frame j is the state after (j+1)*save_every steps.
    """
    nframes = nsteps // save_every
    x, k = x0, k0
    xs, ks, ts = [], [], []
    for j in range(nframes):
        for i in range(save_every):
            x, k = step_fn(x, k, t0 + (j * save_every + i) * dt)
        xs.append(x)
        ks.append(k)
        ts.append(t0 + (j + 1) * save_every * dt)
    empty = x0.new_zeros((0,) + tuple(x0.shape))
    return (torch.stack(xs) if xs else empty,
            torch.stack(ks) if ks else empty,
            torch.tensor(ts, dtype=torch.float64))
