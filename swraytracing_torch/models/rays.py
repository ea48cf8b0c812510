"""Ray integrators for wave-packet tracing.

Counterpart of swraytracing_tpu/models/rays.py, vectorised over packets:
  * symplectic Strang splitting phi1(dt/2) o phi2(dt) o phi1(dt/2)
    (ode_symplectic.m:13-37) plus the 4th-order Yoshida composition the
    reference sketches but never wires up (ode_symplectic.m:39-53);
  * coupled RK4 / fixed-step RK23 on the full ray RHS
    dx/dt = U + Cg^2 k/omega, dk/dt = -(grad U)^T k with time-blended
    flow snapshots — the production ode23 path
    (qg_flow_ray_trace/qgsw_raytrace.m:258-268); rk23_step uses the same
    Bogacki–Shampine stages at fixed step, and rk23_adaptive is the
    adaptive ode23 itself (a validation path);
  * the frozen-coefficient RK4 steppers rk4_frozen_step / rk4_xka_step
    (ray_trace_sw/step_packet.m, step_packet_xka.m), the latter with
    spatially varying depth and the wave-action equation da/dt = -a divC.

All packets advance in one batched update; there is no per-packet loop.
Everything is differentiable end to end through autograd. A `flow` is any
object with `.at(x, y, alpha) -> FlowEval` (models/fields.py).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .dispersion import Dispersion
from ..ops.interp import interpolate

__all__ = [
    "RayState",
    "ray_rhs",
    "symplectic_step",
    "yoshida4_step",
    "rk4_step",
    "rk23_step",
    "rk23_adaptive",
    "rk4_frozen_step",
    "rk4_xka_step",
    "integrate_rays",
]


class RayState(NamedTuple):
    x: torch.Tensor              # (2, Np) positions, coordinate axis first
    k: torch.Tensor              # (2, Np) wavenumbers
    a: torch.Tensor | None = None  # (Np,) wave action (optional)


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


def rk23_adaptive(x, k, T, disp: Dispersion, flow, rtol: float = 1e-6,
                  atol: float = 1e-7, dt0: float | None = None,
                  max_steps: int = 200_000):
    """Adaptive Bogacki–Shampine over [0, T] — the reference's actual
    production sub-cycling (MATLAB ode23 at qgsw_raytrace.m:149, with the
    tolerances of SW_zero_background_raytracing.m:71-79). The flow blend
    fraction is alpha = t/T, the reference's interpolate_U convention over
    one flow step.

    Error control matches MATLAB's: componentwise
    E = max |err_i| / max(|y_i|, |ynew_i|, atol/rtol) over the packed
    (x, k) state of ALL packets (one shared step), accept iff E <= rtol,
    FSAL, step factor 0.8*(rtol/E)^(1/3) clipped to [0.2, 5].

    VALIDATION-ONLY path: a Python loop that reads the error norm back
    once per attempted step (one synchronisation each); the production
    paths use the fixed-substep rk23_step. Time and step size are host
    floats.

    Returns (x, k, t_end, n_accepted, n_attempted). Callers MUST check
    t_end == T: if the max_steps budget ran out first the state is the
    partial integration to t_end.
    """
    T = float(T)
    thresh = atol / rtol

    def f(xx, kk, t):
        return ray_rhs(xx, kk, t / T, disp, flow)

    def enorm(err, y0, y1):
        sc = torch.clamp(torch.maximum(y0.abs(), y1.abs()), min=thresh)
        return (err.abs() / sc).max()

    dt = T / 100.0 if dt0 is None else float(dt0)
    t, n_acc, n_att = 0.0, 0, 0
    f1x, f1k = f(x, k, 0.0)
    while t < T and n_att < max_steps:
        h = min(dt, T - t)
        dx2, dk2 = f(x + 0.5 * h * f1x, k + 0.5 * h * f1k, t + 0.5 * h)
        dx3, dk3 = f(x + 0.75 * h * dx2, k + 0.75 * h * dk2, t + 0.75 * h)
        xn = x + h * (2.0 * f1x + 3.0 * dx2 + 4.0 * dx3) / 9.0
        kn = k + h * (2.0 * f1k + 3.0 * dk2 + 4.0 * dk3) / 9.0
        dx4, dk4 = f(xn, kn, t + h)
        ex = h * (-5.0 * f1x / 72.0 + dx2 / 12.0 + dx3 / 9.0 - dx4 / 8.0)
        ek = h * (-5.0 * f1k / 72.0 + dk2 / 12.0 + dk3 / 9.0 - dk4 / 8.0)
        E = float(torch.maximum(enorm(ex, x, xn), enorm(ek, k, kn)))
        n_att += 1
        dt = h * min(max(0.8 * (rtol / max(E, 1e-300)) ** (1.0 / 3.0),
                         0.2), 5.0)
        if E <= rtol:
            x, k, f1x, f1k = xn, kn, dx4, dk4   # FSAL
            t += h
            n_acc += 1
    return x, k, t, n_acc, n_att


# ---------------------------------------------------------------------------
# Reference-parity frozen-coefficient steppers
# ---------------------------------------------------------------------------

def rk4_frozen_step(x, k, dt, disp: Dispersion, flow):
    """step_packet semantics (ray_trace_sw/step_packet.m): RK4 on x with
    the group velocity frozen at the initial k and U interpolated at the
    substage positions; then RK4 on k with the velocity gradients frozen
    at the *initial* position (step_packet.m:58-61)."""
    C = disp.group_velocity(k)

    def vel(xx):
        u, v = flow.velocity_at(xx[0], xx[1])
        return torch.stack([u, v], dim=0) + C

    x1 = dt * vel(x)
    x2 = dt * vel(x + 0.5 * x1)
    x3 = dt * vel(x + 0.5 * x2)
    x4 = dt * vel(x + x3)
    xn = x + (x1 + 2 * x2 + 2 * x3 + x4) / 6.0

    ev = flow.at(x[0], x[1])
    k1 = -dt * ev.refraction(k)
    k2 = -dt * ev.refraction(k + 0.5 * k1)
    k3 = -dt * ev.refraction(k + 0.5 * k2)
    k4 = -dt * ev.refraction(k + k3)
    kn = k + (k1 + 2 * k2 + 2 * k3 + k4) / 6.0
    return xn, kn


def rk4_xka_step(x, k, a, dt, disp: Dispersion, flow, H=None):
    """step_packet_xka semantics (ray_trace_sw/step_packet_xka.m): frozen
    group velocity for the position RK4; gradients, grad-omega refraction
    and div C interpolated at the *new* position (step_packet_xka.m:59-65);
    RK4 on k including the depth-refraction terms; RK4 on wave action
    da/dt = -a div C.

    H: optional (nx, ny) depth factor grid (1 + eta_g); if given, the
    local group velocity uses the depth interpolated with the flow's
    stencil order (2 for a flow without one).
    """
    grid = flow.grid
    order = getattr(flow, "order", 2)
    if H is not None:
        H0 = interpolate(H, x[0], x[1], grid, order)
        C = disp.group_velocity_depth(k, H0)
    else:
        C = disp.group_velocity(k)

    def vel(xx):
        u, v = flow.velocity_at(xx[0], xx[1])
        return torch.stack([u, v], dim=0) + C

    x1 = dt * vel(x)
    x2 = dt * vel(x + 0.5 * x1)
    x3 = dt * vel(x + 0.5 * x2)
    x4 = dt * vel(x + x3)
    xn = x + (x1 + 2 * x2 + 2 * x3 + x4) / 6.0

    ev = flow.at(xn[0], xn[1])
    Hn = (interpolate(H, xn[0], xn[1], grid, order) if H is not None
          else None)
    divC, domx, domy = disp.div_group_velocity(k, ev.u, ev.v, Hn)
    gom = torch.stack([domx, domy], dim=0)

    def dk(kk):
        return -dt * (ev.refraction(kk) + gom)

    k1 = dk(k)
    k2 = dk(k + 0.5 * k1)
    k3 = dk(k + 0.5 * k2)
    k4 = dk(k + k3)
    kn = k + (k1 + 2 * k2 + 2 * k3 + k4) / 6.0

    a1 = dt * (-a * divC)
    a2 = dt * (-(a + 0.5 * a1) * divC)
    a3 = dt * (-(a + 0.5 * a2) * divC)
    a4 = dt * (-(a + a3) * divC)
    an = a + (a1 + 2 * a2 + 2 * a3 + a4) / 6.0
    return xn, kn, an


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
