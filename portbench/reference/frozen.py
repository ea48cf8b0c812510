"""Frozen-snapshot raytracing, plain (SW_zero_background_raytracing.m,
symplectic_full_fourier.m, ode_symplectic.m).

Copied from swraytracing_torch/models/frozen.py, models/fields.py
(flow_from_qk) and models/rays.py (symplectic_step) at the commit that
added it: a one-layer QG PV frame made by spinning up the ring IC; the
frame inverted, psi_k = -q_k / (K_d^2 + K^2), into the six grids u, v,
u_x, u_y, v_x, v_y by spectral differentiation; packets marched through
the frozen grids by Strang steps phi1(dt/2) o phi2(dt) o phi1(dt/2)
(phi1 the free drift x += h C(k), phi2 the kick x += dt U(x),
k -= dt (grad U)^T k at the pre-kick position); and the ray invariant
Omega_abs = omega(k) + U . k, whose largest relative change over the
packets is the script's check of an integrator (here with |Omega_abs(0)|
held at least omega(k(0)) from zero: conservation_error).

Where it departs from the published scripts, as the port does:
  * the frame is not read from a saved qgsw run (frame 2000 of
    analysis/pv): it is the ring IC from the seed advanced `spinup_steps`
    steps by reference/qg's one-layer step (K_d^2 = f/Cg, as
    qgsw_raytrace.m:27 sets it);
  * each grid is interpolated with the 6 x 6 Lagrange stencil of order 2
    (interpolate.m:12-50) on the periodic grid, as reference/stencil does
    for the coupled march, in place of SpectralScheme.m's full Fourier
    sum; the gradient is that of the spectral grids u_x, u_y, v_x, v_y
    interpolated on their own, not the interpolant's derivative;
  * the packets march a fixed dt (ode_symplectic.m), never ode23 / ode45.

Every grid and packet state is stored through `rnd` (reference/__init__);
the packets march in blocks, so the reference fits beside any count.
"""

import numpy as np
import torch

from . import exact, hist
from .stencil import OFFSETS, _cell, weights


def spin_up(R, qk, dt, steps, rnd=exact):
    """qk (nx, nky) after `steps` AB3 steps of length dt (Euler, AB2,
    then AB3)."""
    q = qk[None]
    r1 = r2 = torch.zeros_like(q)
    for n in range(steps):
        q, r1, r2 = R.step(q, r1, r2, np.array([n]), np.array([dt]), rnd)
    return q[0]


def six_grids(R, qk, rnd=exact):
    """(6, nx, ny) grids u, v, u_x, u_y, v_x, v_y of the PV spectrum qk."""
    g = R.grid
    psik = R.psik(qk)
    uk, vk = -g.ddy(psik), g.ddx(psik)
    comps = torch.stack([uk, vk, g.ddx(uk), g.ddy(uk), g.ddx(vk),
                         g.ddy(vk)])
    return rnd(g.to_grid(comps))


def grids_at(G, x, dx, dy):
    """(nf, P) values of the grids G (nf, nx, ny) at positions x (2, P),
    each by the 6 x 6 Lagrange stencil on the periodic grid."""
    nf, nx, ny = G.shape
    i0, fx = _cell(x[0], dx, nx)
    j0, fy = _cell(x[1], dy, ny)
    wx, wy = weights(fx)[0], weights(fy)[0]                 # (P, 6)
    off = torch.tensor(OFFSETS, device=x.device)
    ix = torch.remainder(i0[:, None] + off, nx)
    iy = torch.remainder(j0[:, None] + off, ny)
    idx = (ix[:, :, None] * ny + iy[:, None, :]).reshape(-1)
    vals = G.reshape(nf, nx * ny)[:, idx].reshape(nf, -1, 6, 6)
    return ((vals * wy[None, :, None, :]).sum(-1) * wx[None]).sum(-1)


def omega(k, f, Cg):
    return torch.sqrt(f * f + Cg * Cg * (k * k).sum(0))


def omega_abs(G, x, k, f, Cg, dx, dy):
    """omega(k) + U(x) . k."""
    uv = grids_at(G[:2], x, dx, dy)
    return omega(k, f, Cg) + (uv * k).sum(0)


def conservation_error(om, om0, omega0):
    """Largest |Omega_abs - Omega_abs(0)| / max(|Omega_abs(0)|,
    omega(k(0))) over the packets (last axis): the script's
    |dOmega_abs / Omega_abs(0)| wherever |Omega_abs(0)| >= omega(k(0)).
    Elsewhere the flow's Doppler shift U . k cancels omega, and the
    script's ratio is ill-conditioned: Omega_abs(0) passes through zero,
    and where the frozen strain has grown |k| by orders of magnitude U . k
    and omega cancel, so a position gap of 1e-4 moves Omega_abs by O(1).
    Dividing by omega(k(0)) there measures the change against the size of
    the terms that cancel."""
    return ((om - om0).abs() / torch.maximum(om0.abs(), omega0)).amax(-1)


def march(G, x, k, dt, steps, every, f, Cg, dx, dy, bins, omega_max,
          block=1 << 18, rnd=exact):
    """x, k (2, P) through the frozen grids G (6, nx, ny): `steps` Strang
    steps, a frame after each `every` (at least one frame). Returns the
    frames' x and k (steps // every, 2, P), their omega histogram rows
    (steps // every, bins + 1) and their conservation_error
    (steps // every,)."""
    gH = Cg * Cg
    xs, ks, rows, cons = [], [], 0, []
    for b0 in range(0, x.shape[-1], block):
        xb, kb = x[:, b0:b0 + block], k[:, b0:b0 + block]
        om0 = omega_abs(G, xb, kb, f, Cg, dx, dy)
        w0 = omega(kb, f, Cg)
        fx, fk, fr, fc = [], [], [], []
        for s in range(steps // every * every):
            xb = rnd(xb + 0.5 * dt * gH * kb / omega(kb, f, Cg))
            u, v, ux, uy, vx, vy = grids_at(G, xb, dx, dy)
            xb = rnd(xb + dt * torch.stack([u, v]))
            kb = rnd(kb - dt * torch.stack([ux * kb[0] + vx * kb[1],
                                            uy * kb[0] + vy * kb[1]]))
            xb = rnd(xb + 0.5 * dt * gH * kb / omega(kb, f, Cg))
            if (s + 1) % every == 0:
                fx.append(xb)
                fk.append(kb)
                fr.append(hist.counts(kb[None], f, Cg, bins,
                                      [omega_max])[0])
                fc.append(conservation_error(
                    omega_abs(G, xb, kb, f, Cg, dx, dy), om0, w0))
        xs.append(torch.stack(fx))
        ks.append(torch.stack(fk))
        rows = rows + torch.stack(fr)
        cons.append(torch.stack(fc))
    return (torch.cat(xs, -1), torch.cat(ks, -1), rows,
            torch.stack(cons).amax(0))
