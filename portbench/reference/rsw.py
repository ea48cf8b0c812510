"""RSW restart-frame raytracing, plain (ray_trace_sw/raytrace_sw.m:10-53,
step_packet_xka.m:38-91, cg_sw.m; the frame from rsw/swk.m).

Written from the semantics the port's docstrings state, in float64, and
independent of the port: the initial state of wavespecic2d.m (the
run_swkU.m wave bath of random-phase gravity waves, |k| <= k_max_wave,
scaled to max |h| = aw, plus random-phase geostrophic flow on
k_geo_lo < |k| <= k_geo_hi scaled to max speed ag; swraytracing_torch's
models/examples.wave_and_geostrophic_spectrum_ic draws the same numbers
from numpy.random.default_rng(seed)); its spin-up by swk (rsw/swk.m):
the vorticity/Bernoulli right-hand side

    u_t =  v (f + zeta) - B_x,   v_t = -u (f + zeta) - B_y,
    h_t = -(u h)_x - (v h)_y - div u,   B = (u^2 + v^2)/2 + Cg^2 h,

its products on the 3/2 zero-padded grid, AB3 whose first right-hand
side fills both history slots (swk.m:139), the trapezoidal hyperviscosity
filter pair on u and v (swk.m:102-109) and the Courant time step
dttune dx / max(max |u|, max |v|, sqrt(Cg^2 + f^2)), the maximum read on
the padded grid (swk.m:151); the wave/vortex decomposition (each mode
projected onto the vortical eigenvector (-i l C, i k C, f) of (u, v, C h),
rsw/wavevortdecomp.m); the seven grids (ug, vg, their four gradients by
spectral differentiation, H = 1 + eta_g, raytrace_sw.m:25-53); and the
x-k-a march of step_packet_xka.m:38-91 with cg_sw.m's terms:

    C = gH H(x) k / omega_H,  omega_H = sqrt(f^2 + gH H |k|^2), frozen;
    x: RK4 on dx/dt = U(x) + C;
    at the new position: U, grad U, H, then div C = (k f v - l f u
    - |c|^2) / omega_H and grad omega = (f |k|^2 v, -f |k|^2 u) / (2 omega_H)
    with c = gH H k / omega_H;
    k: RK4 on dk/dt = -((grad U)^T k + grad omega), the terms frozen;
    a: RK4 on da/dt = -a div C.

Where it departs from the published scripts, as the port does:
  * the frame is not read from a restart file
    (wavevort_231058_restart_frame100): it is the seed's initial state
    advanced `spinup_steps` swk steps;
  * no blow-up test (swk.m:144-148): a run that blows up fails the
    comparison anyway;
  * each grid is interpolated with the 6 x 6 Lagrange stencil of order 2
    (interpolate.m:12-50) on the periodic grid (reference/frozen.grids_at,
    built on reference/stencil), the gradients being the spectral grids
    interpolated on their own;
  * the packets march a fixed dt.

Every state, grid and packet is stored through `rnd` (reference/__init__);
the packets march in blocks, so the reference fits beside any count.
TF32 is off: no product here may run in a precision below float32.
"""

import math

import numpy as np
import torch

from . import exact, hist
from .frozen import grids_at
from .spectral import Grid

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _xy(g):
    x = g.t(g.dx * np.arange(g.nx))
    return torch.meshgrid(x, x, indexing="ij")


def initial(seed, cfg, device, dtype=torch.float64, rnd=exact):
    """(3, nx, ny) grids u, v, h of the wave bath plus geostrophic flow
    drawn from the seed."""
    g = Grid(cfg["nx"], cfg["L"], device, dtype)
    f, C = cfg["f"], cfg["Cg"]
    X, Y = _xy(g)
    scale = 2 * math.pi / g.L
    rng = np.random.default_rng(int(seed))
    kw = min(g.kmax, cfg["k_max_wave"])
    uw, vw, hw = (torch.zeros_like(X) for _ in range(3))
    for k in range(-kw, kw + 1):
        for l in range(0, kw + 1):
            K2i = k * k + l * l
            if K2i == 0 or K2i > cfg["k_max_wave"] ** 2:
                continue
            sign = 1 if rng.random() > 0.5 else -1
            phase = rng.uniform(0, 2 * np.pi)
            kk, ll = scale * k, scale * l
            w = sign * math.sqrt(f * f + C * C * (kk * kk + ll * ll))
            th = kk * X + ll * Y + phase
            K2 = kk * kk + ll * ll
            hw += torch.cos(th)
            uw += (kk * w * torch.cos(th) - ll * f * torch.sin(th)) / K2
            vw += (ll * w * torch.cos(th) + kk * f * torch.sin(th)) / K2
    s = cfg["aw"] / max(float(hw.abs().max()), 1e-30)
    uw, vw, hw = s * uw, s * vw, s * hw

    rng = np.random.default_rng(int(seed))
    kg = min(g.kmax, cfg["k_geo_hi"])
    psi = torch.zeros_like(X)
    for k in range(-kg, kg + 1):
        for l in range(0, kg + 1):
            K2i = k * k + l * l
            if not cfg["k_geo_lo"] ** 2 < K2i <= cfg["k_geo_hi"] ** 2:
                continue
            phi = rng.uniform(0, 2 * np.pi)
            psi += torch.cos(scale * k * X + scale * l * Y + phi) / K2i
    psik = g.to_spectral(psi)
    ug, vg = g.to_grid(-g.ddy(psik)), g.to_grid(g.ddx(psik))
    hg = f / (C * C) * psi
    s = cfg["ag"] / max(float(torch.sqrt(ug * ug + vg * vg).max()), 1e-30)
    return rnd(torch.stack([uw + s * ug, vw + s * vg, hw + s * hg]))


class SWK:
    """The nonlinear RSW step of a configuration (a dict of its keys)."""

    def __init__(self, cfg, device, dtype=torch.float64):
        self.f, self.Cg = cfg["f"], cfg["Cg"]
        prm = cfg["rsw_params"]
        self.g = g = Grid(cfg["nx"], cfg["L"], device, dtype)
        self.big = Grid(3 * g.nx // 2, cfg["L"], device, dtype)
        self.dttune = prm["dttune"]
        self.cmax = math.sqrt(self.Cg ** 2 + self.f ** 2)
        ikx = np.fft.fftfreq(g.nx, 1.0 / g.nx)[:, None]
        iky = np.arange(g.nky)[None, :]
        Ka = np.sqrt(ikx ** 2 + iky ** 2) ** prm["hyper_order"]
        nudt = prm["nutune"] * 2 * np.pi / (g.nx * g.kmax
                                            ** prm["hyper_order"])
        fR = 1.0 / (1.0 + 0.5 * nudt * Ka)
        fU = (1.0 - 0.5 * nudt * Ka) * fR
        one = np.ones_like(fR)
        self.fU = g.t(np.stack([fU, fU, one]) * g.mask_np)
        self.fR = g.t(np.stack([fR, fR, one]) * g.mask_np)

    def pad(self, fk):
        g, b = self.g, self.big
        out = fk.new_zeros(fk.shape[:-2] + (b.nx, b.nky))
        h = g.nx // 2
        out[..., :h, :g.nky] = fk[..., :h, :]
        out[..., b.nx - h:, :g.nky] = fk[..., g.nx - h:, :]
        return out

    def unpad(self, fk):
        g, b = self.g, self.big
        h = g.nx // 2
        out = torch.cat([fk[..., :h, :g.nky], fk[..., b.nx - h:, :g.nky]],
                        dim=-2)
        return out * g.mask

    def rhs(self, S):
        """(3, nx, nky) right-hand side of the spectra S of (u, v, h), and
        max(max |u|, max |v|) on the padded grid."""
        g, f = self.g, self.f
        uk, vk, hk = S
        zk = g.ddx(vk) - g.ddy(uk)
        divk = g.ddx(uk) + g.ddy(vk)
        u, v, h, z = self.big.to_grid(self.pad(torch.stack([uk, vk, hk,
                                                            zk])))
        umax = torch.maximum(u.abs().max(), v.abs().max())
        vz, uz, ke, uh, vh = self.unpad(self.big.to_spectral(torch.stack(
            [v * z, u * z, 0.5 * (u * u + v * v), u * h, v * h])))
        Bk = ke + self.Cg ** 2 * hk
        return torch.stack([vz + f * vk - g.ddx(Bk),
                            -uz - f * uk - g.ddy(Bk),
                            -g.ddx(uh) - g.ddy(vh) - divk]), umax

    def spin_up(self, S0, steps, rnd=exact):
        """(3, nx, ny) grids after `steps` AB3 steps from the grids S0."""
        g = self.g
        S = rnd(g.to_spectral(S0))
        r1 = r2 = None
        for n in range(steps):
            R, umax = self.rhs(S)
            if n == 0:
                r1 = r2 = R
            dt = self.dttune * g.dx / torch.clamp_min(umax, self.cmax)
            S = rnd(self.fU * S + dt * self.fR * (23 / 12 * R - 16 / 12 * r1
                                                  + 5 / 12 * r2))
            r1, r2 = rnd(R), r1
        return rnd(g.to_grid(S))


def seven_grids(cfg, S, rnd=exact):
    """(7, nx, ny) ug, vg, ug_x, ug_y, vg_x, vg_y, H of the grids S (3, nx,
    ny): the geostrophic part of the wave/vortex decomposition."""
    g = Grid(cfg["nx"], cfg["L"], S.device, S.real.dtype)
    f, C = cfg["f"], cfg["Cg"]
    uk, vk, chk = g.to_spectral(torch.stack([S[0], S[1], C * S[2]]))
    eu, ev = -1j * g.ky * C, 1j * g.kx * C     # (-i l C, i k C, f)
    proj = (torch.conj(eu) * uk + torch.conj(ev) * vk + f * chk) / (
        f * f + C * C * g.K2)
    ug, vg, hgC = g.to_grid(torch.stack([proj * eu, proj * ev, proj * f]))
    Sk = g.to_spectral(torch.stack([ug, vg]))
    grads = g.to_grid(torch.stack([g.ddx(Sk[0]), g.ddy(Sk[0]),
                                   g.ddx(Sk[1]), g.ddy(Sk[1])]))
    return rnd(torch.cat([torch.stack([ug, vg]), grads,
                          (1.0 + hgC / C)[None]]))


def xka_step(G, G3, x, k, a, dt, f, gH, dx, dy):
    """One x-k-a step of packets x, k (2, P), a (P,) through the seven
    grids G, G3 = G's u, v and H."""
    u0, v0, H0 = grids_at(G3, x, dx, dy)
    K2 = (k * k).sum(0)
    gHH = gH * H0
    C = gHH * k / torch.sqrt(f * f + gHH * K2)
    U0 = torch.stack([u0, v0])
    x1 = dt * (U0 + C)
    x2 = dt * (grids_at(G[:2], x + 0.5 * x1, dx, dy) + C)
    x3 = dt * (grids_at(G[:2], x + 0.5 * x2, dx, dy) + C)
    x4 = dt * (grids_at(G[:2], x + x3, dx, dy) + C)
    xn = x + (x1 + 2 * x2 + 2 * x3 + x4) / 6
    u, v, ux, uy, vx, vy, H = grids_at(G, xn, dx, dy)
    gHn = gH * H
    om = torch.sqrt(f * f + gHn * K2)
    cx, cy = gHn * k[0] / om, gHn * k[1] / om
    divC = (k[0] * f * v - k[1] * f * u - cx * cx - cy * cy) / om
    gom = torch.stack([f * K2 * v, -f * K2 * u]) / (2 * om)

    def dk(q):
        return -dt * (torch.stack([ux * q[0] + vx * q[1],
                                   uy * q[0] + vy * q[1]]) + gom)

    q1 = dk(k)
    q2 = dk(k + 0.5 * q1)
    q3 = dk(k + 0.5 * q2)
    q4 = dk(k + q3)
    kn = k + (q1 + 2 * q2 + 2 * q3 + q4) / 6

    def da(b):
        return -dt * b * divC

    r1 = da(a)
    r2 = da(a + 0.5 * r1)
    r3 = da(a + 0.5 * r2)
    r4 = da(a + r3)
    return xn, kn, a + (r1 + 2 * r2 + 2 * r3 + r4) / 6


def march(G, x, k, a, dt, steps, every, f, Cg, dx, dy, bins, omega_max,
          block=1 << 18, rnd=exact):
    """x, k (2, P), a (P,) through the seven grids G: `steps` x-k-a steps,
    a frame after each `every`. Returns the frames' x, k (steps // every,
    2, P), a (steps // every, P) and their omega histogram rows
    (steps // every, bins + 1)."""
    G3 = G[[0, 1, 6]]
    xs, ks, as_, rows = [], [], [], 0
    for b0 in range(0, x.shape[-1], block):
        xb, kb = x[:, b0:b0 + block], k[:, b0:b0 + block]
        ab = a[b0:b0 + block]
        fx, fk, fa, fr = [], [], [], []
        for s in range(steps // every * every):
            xb, kb, ab = (rnd(t) for t in xka_step(G, G3, xb, kb, ab, dt, f,
                                                   Cg * Cg, dx, dy))
            if (s + 1) % every == 0:
                fx.append(xb)
                fk.append(kb)
                fa.append(ab)
                fr.append(hist.counts(kb[None], f, Cg, bins,
                                      [omega_max])[0])
        xs.append(torch.stack(fx))
        ks.append(torch.stack(fk))
        as_.append(torch.stack(fa))
        rows = rows + torch.stack(fr)
    return (torch.cat(xs, -1), torch.cat(ks, -1), torch.cat(as_, -1), rows)
