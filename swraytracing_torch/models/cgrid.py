"""Arakawa C-grid finite-difference RSW solver (the reference's swp).

Counterpart of swraytracing_tpu/models/cgrid.py, the re-design of
rsw/swp.m: rotating shallow water on a C-grid (h/B at cell centers, u at
E-W faces, v at N-S faces, vorticity at corners), centered differences,
Williamson RK3, adaptive dt and viscosity, beta-plane Coriolis, bottom
topography h_b, linear drag, mass forcing Hdot, periodic or
free-slip-wall BCs per axis, geostrophic initialisation. The staggered
average/difference helpers reproduce rsw/avg.m:1-14 and rsw/dif.m:1-13
exactly (including the shift and wall edge rules); `laplacian` is
implemented here — the reference calls it (swp.m:392,405) but ships no
such function.

State arrays are the interior (nx, ny) C-grid fields (the reference
carries an extra zero boundary row/col it never updates). Every edge rule
is out of place: no function writes into a tensor its caller holds.

`swp` runs on `device` (None = the CUDA device; raises when there is
none) in float64 by default, as the JAX package asks for. The adaptive dt
and viscosity stay on the device; `t` is a float64 device tensor summed
from the steps' dts, and no step reads a value back to the host.
"""

from __future__ import annotations

import pathlib
from typing import NamedTuple

import numpy as np
import torch

from ..io import binio
from ..ops.grid import as_tensor, resolve_device

__all__ = ["avg", "dif", "laplacian", "SWPParams", "swp", "swp_to_files",
           "cgrid_pv", "geostrophic_velocities", "cgrid_divergence"]

_RK3 = (1.0 / 3.0, 5.0 / 9.0, 15.0 / 16.0, 153.0 / 128.0, 8.0 / 15.0)


def _last_along(f, d):
    """f's last slice along axis d, keeping the axis."""
    return f.narrow(d, f.shape[d] - 1, 1)


def _set_last(fa, d, last):
    """fa with its last slice along axis d replaced by `last` (out of
    place)."""
    return torch.cat([fa.narrow(d, 0, fa.shape[d] - 1), last], dim=d)


def _finish(fa, d, shift, endoff):
    if shift:
        fa = torch.roll(fa, 1, dims=d)
    if endoff:
        fa = fa.narrow(d, 0, fa.shape[d] - 1)
    return fa


def avg(f, d: int, periodic: bool = False, shift: bool = False,
        endoff: bool = False):
    """Staggered 2-point average along axis d (rsw/avg.m)."""
    fa = 0.5 * (f + torch.roll(f, -1, dims=d))
    if not periodic:  # wall rule: fa(end) = f(end)/2
        fa = _set_last(fa, d, 0.5 * _last_along(f, d))
    return _finish(fa, d, shift, endoff)


def dif(f, d: int, periodic: bool = False, shift: bool = False,
        endoff: bool = False):
    """Staggered forward difference along axis d (rsw/dif.m)."""
    fd = torch.roll(f, -1, dims=d) - f
    if not periodic:  # wall rule: fd(end) = -f(end)
        fd = _set_last(fd, d, -_last_along(f, d))
    return _finish(fd, d, shift, endoff)


def laplacian(f, dx, dy, periodx: bool = False, periody: bool = False):
    """5-point Laplacian via the staggered dif pair — the function
    swp.m:392 calls but the reference never defines."""
    fxx = dif(dif(f, 0, periodx), 0, periodx, shift=True) / dx**2
    fyy = dif(dif(f, 1, periody), 1, periody, shift=True) / dy**2
    return fxx + fyy


class SWPParams(NamedTuple):
    """swp name-value parameters with their defaults (swp.m:93-110)."""

    Roi: float = 0.0          # inverse Rossby number (f0)
    Beta: float = 0.0
    Cg: float = 0.0
    Drag: float = 0.0
    Nu: float = 0.0
    Hdot: float = 0.0
    periodx: bool = True
    periody: bool = True
    dttune: float = 0.2
    Lx: float = 2.0 * np.pi
    Ly: float = 2.0 * np.pi


def _coriolis(p: SWPParams, ny: int, dy: float, like: torch.Tensor):
    """f = Roi + Beta*y on u rows (y at j+1/2) and v rows (y at j)
    (swp.m:176-182), (1, ny) rows in like's dtype on its device."""
    yu = dy * (np.arange(ny) + 0.5)
    yv = dy * np.arange(ny)
    return tuple(torch.as_tensor(p.Roi + p.Beta * y, dtype=like.dtype,
                                 device=like.device)[None, :]
                 for y in (yu, yv))


def _zero_first(f, d):
    """f with its first slice along axis d set to 0 (out of place)."""
    first = torch.zeros_like(f.narrow(d, 0, 1))
    return torch.cat([first, f.narrow(d, 1, f.shape[d] - 1)], dim=d)


def swp_rhs(u, v, H, hb, p: SWPParams, dx, dy, nu, fcor_u, fcor_v):
    """C-grid RHS (swp.m:361-418). H = h - hb is the advected depth."""
    px, py = p.periodx, p.periody
    h = H + hb
    zeta = dif(v, 0, px, shift=True) / dx - dif(u, 1, py, shift=True) / dy
    if not px:
        zeta = _zero_first(zeta, 0)
        u = _zero_first(u, 0)
    if not py:
        zeta = _zero_first(zeta, 1)
        v = _zero_first(v, 1)

    B = p.Cg**2 * h + 0.5 * (avg(u, 0, px) ** 2 + avg(v, 1, py) ** 2)

    Ru = (avg(avg(v, 0, px, shift=True), 1, py)
          * (fcor_u + avg(zeta, 1, py))
          - dif(B, 0, px, shift=True) / dx
          + nu * laplacian(u, dx, dy, px, py) - p.Drag * u)
    Rv = (-avg(avg(u, 0, px), 1, py, shift=True)
          * (fcor_v + avg(zeta, 0, px))
          - dif(B, 1, py, shift=True) / dy
          + nu * laplacian(v, dx, dy, px, py) - p.Drag * v)
    RH = (-dif(u * avg(H, 0, px, shift=True), 0, px) / dx
          - dif(v * avg(H, 1, py, shift=True), 1, py) / dy + p.Hdot)
    return Ru, Rv, RH


def swp(u0, v0, h0, p: SWPParams = SWPParams(), hb=None, nt: int = 500,
        save_every: int = 100, geovel: bool = False, t0: float = 0.0, *,
        device=None, dtype: torch.dtype = torch.float64):
    """Run the C-grid model nt steps (swp.m main loop :240-330).

    Args:
      u0, v0, h0: (nx, ny) C-grid fields (staggered interpretation).
      hb: optional bottom topography at h points.
      t0: model time of the input fields — the reference's F_in.time
        restart support (swp.m:26-28,120-122); pass the t of a previous
        run's last frame to continue its clock.
    Returns (u, v, h frames each (nf, nx, ny), t (nf,) float64, ke, ape,
    htot), tensors on `device`.
    """
    device = resolve_device(device)
    u0, v0, h0 = (as_tensor(a, dtype, device) for a in (u0, v0, h0))
    nx, ny = h0.shape
    dx, dy = p.Lx / nx, p.Ly / ny
    dr = 2 * dx * dy / (dx + dy)                      # swp.m:160
    hb_a = (torch.zeros_like(h0) if hb is None
            else as_tensor(hb, dtype, device))
    fcor_u, fcor_v = _coriolis(p, ny, dy, h0)
    if geovel:
        u0, v0 = geostrophic_velocities(h0, p, dx, dy)
    c1, c2, c3, c4, c5 = _RK3

    def rhs3(F, nu):
        return torch.stack(swp_rhs(F[0], F[1], F[2], hb_a, p, dx, dy, nu,
                                   fcor_u, fcor_v))

    F = torch.stack([u0, v0, h0 - hb_a])
    t = torch.tensor(float(t0), dtype=torch.float64, device=device)
    frames = []
    for _ in range(nt // save_every):
        for _ in range(save_every):
            umax = torch.clamp_min(torch.amax(torch.abs(F[:2])), p.Cg)
            dt = p.dttune * dr / umax                 # swp.m:325-327
            nu = p.Nu * dr**2 / dt
            R = dt * rhs3(F, nu)
            F1 = F + c1 * R
            R1 = dt * rhs3(F1, nu) - c2 * R
            F2 = F1 + c3 * R1
            F = F2 + c5 * (dt * rhs3(F2, nu) - c4 * R1)
            t = t + dt
        u, v, H = F[0], F[1], F[2]
        h = H + hb_a
        ke = 0.5 * torch.sum(avg(u, 0, p.periodx) ** 2
                             + avg(v, 1, p.periody) ** 2)
        ape = 0.5 * p.Cg**2 * torch.sum(h * h)
        htot = torch.sum(H)
        frames.append((u, v, h, t, ke, ape, htot))
    if not frames:
        empty = h0.new_zeros((0, nx, ny))
        scalars = h0.new_zeros(0)
        return (empty, empty, empty, scalars.to(torch.float64), scalars,
                scalars, scalars)
    return tuple(torch.stack([fr[i] for fr in frames]) for i in range(7))


def swp_to_files(u0, v0, h0, out_dir, p: SWPParams = SWPParams(), hb=None,
                 nt: int = 500, save_every: int = 100, geovel: bool = False,
                 idstring: str = "", frame0: int = 0, t0: float = 0.0, *,
                 device=None, dtype: torch.dtype = torch.float64):
    """swp with the reference's direct-to-file output and restart-field
    workflow (swp.m writetofiles flag :53-58, F_in.frame/F_in.time
    :26-28): frames of u, v, h, zeta, q and time are appended to
    frame-addressed binaries u<idstring>.bin ... in `out_dir`, numbered
    from frame0+1; pass the returned (frame, time) back in to continue a
    run from its last saved state. zeta and q are formed on the device;
    every frame comes to the host once, after the run.

    Returns (restart dict {u, v, h, frame, time}, diag dict
    {t, ke, ape, htot} arrays) — the reference's (F_out, Diag_out) — as
    numpy arrays."""
    us, vs, hs, ts, kes, apes, htots = swp(
        u0, v0, h0, p, hb=hb, nt=nt, save_every=save_every, geovel=geovel,
        t0=t0, device=device, dtype=dtype)
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    dx, dy = p.Lx / hs.shape[1], p.Ly / hs.shape[2]
    hb_a = (torch.zeros_like(hs[0]) if hb is None
            else as_tensor(hb, hs.dtype, hs.device))
    zetas = (dif(vs, 1, p.periodx, shift=True) / dx
             - dif(us, 2, p.periody, shift=True) / dy)
    qs = torch.stack([cgrid_pv(us[j], vs[j], hs[j] - hb_a, p, dx, dy)
                      for j in range(us.shape[0])]) if len(us) else zetas
    us, vs, hs, zetas, qs, ts = (a.detach().cpu().numpy()
                                 for a in (us, vs, hs, zetas, qs, ts))
    frame = frame0
    for j in range(us.shape[0]):
        frame += 1
        for name, a in (("u", us[j]), ("v", vs[j]), ("h", hs[j]),
                        ("zeta", zetas[j]), ("q", qs[j])):
            binio.write_field(a, str(out / f"{name}{idstring}.bin"), frame)
        binio.write_field(ts[j], str(out / f"time{idstring}.bin"), frame)
    restart = {"u": us[-1], "v": vs[-1], "h": hs[-1], "frame": frame,
               "time": float(ts[-1])}
    diag = {"t": ts, "ke": kes.detach().cpu().numpy(),
            "ape": apes.detach().cpu().numpy(),
            "htot": htots.detach().cpu().numpy()}
    return restart, diag


def cgrid_pv(u, v, H, p: SWPParams, dx, dy):
    """Potential vorticity q = (f + zeta)/H on vorticity points
    (swp.m:286; cf. rsw/get_swvort.m)."""
    px, py = p.periodx, p.periody
    _, fcor_v = _coriolis(p, H.shape[1], dy, H)
    zeta = dif(v, 0, px, shift=True) / dx - dif(u, 1, py, shift=True) / dy
    Hz = avg(avg(H, 0, px, shift=True), 1, py, shift=True)
    return (fcor_v + zeta) / Hz


def geostrophic_velocities(h, p: SWPParams, dx, dy):
    """u = -(Cg^2/f) h_y, v = (Cg^2/f) h_x on the staggered points
    (swp.m geovel flag; rsw/get_geo_vel.m)."""
    f = p.Roi if p.Roi != 0 else 1.0
    u = -(p.Cg**2 / f) * dif(h, 1, p.periody, shift=True) / dy
    v = (p.Cg**2 / f) * dif(h, 0, p.periodx, shift=True) / dx
    return u, v


def cgrid_divergence(u, v, p: SWPParams, dx, dy):
    """div u on h points (rsw/getdiv.m)."""
    return (dif(u, 0, p.periodx) / dx + dif(v, 1, p.periody) / dy)
