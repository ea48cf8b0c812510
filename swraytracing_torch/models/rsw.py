"""Nonlinear and linearized rotating shallow-water solvers (2-D).

Counterpart of swraytracing_tpu/models/rsw.py, the reference's swk family:
  * `swk` nonlinear RSW in vorticity/Bernoulli form (rsw/swk.m:5-12,
    getrhs :201-217):
        u_t =  v (f + zeta) - B_x
        v_t = -u (f + zeta) - B_y
        h_t = -(u h)_x - (v h)_y - div u,      B = (u^2+v^2)/2 + Cg^2 h
  * `swkU` linearized about a prescribed steady flow (U, V) in
    conservative form (rsw/swkU.m:216-246), with the optional `killpv`
    projection (swkU.m:193-197) and the `swkUqx` residual-PV damping step
    (rsw/swkUqx.m:243-262);
  * `swkU_tc` time-dependent background: the (U, V) grids are recomputed
    from a streamfunction callable every step (rsw/swkU_tc.m:202-205).

Numerics, as the reference: AB3 with trapezoidal hyperviscosity of order
`a` applied to u and v as the per-mode filter pair (fU, fR)
(swk.m:102-109, update at :182), Umax-adaptive dt (Courant, :151),
blow-up detection Umax > 1e6 (:144-148, here a sticky `blown` flag that
freezes the state instead of aborting the run), and exactly dealiased
quadratic products by 3/2 zero-padding (ops/spectral.py), every field of a
product stack padded in one call. The AB3 bootstrap copies the first RHS
into both history slots (swk.m:139).

The adaptive dt depends on the data, so it stays on the device: the state
keeps `dt`, `t` and `blown` as 0-dim device tensors and only `step` on the
host (the bootstrap is a Python branch), and a run reads nothing back to
the host between its frames. `t` accumulates in float64 whatever the
state's dtype, as the MATLAB reference's double does (the JAX package keeps
it in the state's real dtype; ROADMAP C3). Every constant a step multiplies
by is built in the state's dtype on its device, so a float32 run stays
float32 / complex64 throughout.

Particles: `advect_particles` implements the RK4+interpolation particle
step that swk.m:185 *calls* but the reference never defines.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops.grid import SpectralGrid, as_tensor, resolve_device
from ..ops import spectral as sp
from ..ops.interp import interpolate_stack

__all__ = [
    "RSWParams",
    "RSWState",
    "rsw_filters",
    "rsw_init",
    "rsw_rhs",
    "rsw_step",
    "simulate_rsw",
    "swknd",
    "energy",
    "advect_particles",
    "potential_vorticity",
    "wave_vortex_decompose",
    "wave_vortex_spectra",
]


class RSWParams(NamedTuple):
    """Physics + tuning (swk.m:46-49).

    Variant coverage of the reference's swk family:
      * swks ("flux-form") differs from swk ONLY in its Bernoulli
        missing the 1/2 on the kinetic term (swks.m:176 `gprod(u,u) +
        gprod(v,v)` vs swk.m:208 `.5*gprod(u,u)+.5*gprod(v,v)`; its h
        equation is identical despite the header) — set
        bernoulli_half=False to reproduce it;
      * swknd (nondimensional, parameters ep = U/(f Ld), gam = Ld/L) is
        the same solver under the substitution f -> 1/ep,
        Cg^2 -> gam^2/ep^2 on the unit domain — `swknd` below.
    """

    f: float
    Cg: float
    hyper_order: int = 8        # a, nu del^a
    nutune: float = 1.0
    dttune: float = 0.1         # Courant number
    dealias: bool = True
    killpv: bool = False        # swkU.m:50,193-197
    pv_damp_rate: float = 0.0   # swkUqx.m PV_damping rate (0 = off)
    bernoulli_half: bool = True  # False = swks.m:176 variant

    @property
    def Cmax(self):
        return float(np.sqrt(self.Cg**2 + self.f**2))


@dataclasses.dataclass
class RSWState:
    Sk: torch.Tensor       # (3, nx, nky) spectra of (u, v, h)
    rhs_m1: torch.Tensor   # AB3 history
    rhs_m2: torch.Tensor
    t: torch.Tensor        # 0-dim float64 on the state's device
    dt: torch.Tensor       # 0-dim, the state's real dtype: the last step
    step: int              # host
    blown: torch.Tensor    # 0-dim bool: Umax exceeded 1e6 at some step


def rsw_filters(grid: SpectralGrid, p: RSWParams):
    """Trapezoidal hyperdiffusion pair (fU, fR) (swk.m:102-109):
    nudt = nutune*2*pi/(nx*kmax^a); fR = 1/(1 + nudt/2 K^a);
    fU = (1 - nudt/2 K^a) * fR, with K the INTEGER wavenumber magnitude.
    Applied to the u,v layers only. Host numpy arrays (3, nx, nky),
    float64; the stepping functions take them to the state's device and
    dtype once."""
    ikx = np.fft.fftfreq(grid.nx, 1.0 / grid.nx)[:, None]
    iky = np.arange(grid.nky)[None, :]
    K = np.sqrt(ikx**2 + iky**2)
    kmax = grid.kmax
    nudt = p.nutune * 2 * np.pi / (grid.nx * kmax**p.hyper_order)
    Ka = K**p.hyper_order
    fR = 1.0 / (1.0 + 0.5 * nudt * Ka)
    fU = (1.0 - 0.5 * nudt * Ka) * fR
    ones = np.ones_like(fR)
    return (np.stack([fU, fU, ones]) * grid.nyquist_mask,
            np.stack([fR, fR, ones]) * grid.nyquist_mask)


def rsw_init(u0, v0, h0, grid: SpectralGrid, p: RSWParams,
             t0: float = 0.0, *, device=None,
             dtype: torch.dtype = torch.float32) -> RSWState:
    """The state of grids (u0, v0, h0) (numpy arrays or tensors) on
    `device` (None = the CUDA device; raises when there is none) in
    `dtype`, with the first step's dt from their maximum speed."""
    device = resolve_device(device)
    u0, v0, h0 = (as_tensor(a, dtype, device) for a in (u0, v0, h0))
    Sk = sp.to_spectral(torch.stack([u0, v0, h0]), grid)
    z = torch.zeros_like(Sk)
    umax = torch.maximum(torch.max(torch.abs(u0)), torch.max(torch.abs(v0)))
    umax = torch.clamp_min(umax, p.Cmax)
    dt = p.dttune * grid.dx / umax
    return RSWState(Sk=Sk, rhs_m1=z, rhs_m2=z,
                    t=torch.tensor(float(t0), dtype=torch.float64,
                                   device=device),
                    dt=dt, step=0,
                    blown=torch.zeros((), dtype=torch.bool, device=device))


# ---------------------------------------------------------------------------
# RHS
# ---------------------------------------------------------------------------

def _to_work_grid(stack, grid, dealias):
    """Inverse-transform a stack of spectra to the (padded) work grid, the
    whole stack padded in one call."""
    if not dealias:
        return sp.to_grid(stack, grid), grid
    big = sp.padded_grid(grid)
    return sp.to_grid(sp._pad_spectrum(stack, grid, big.nx, big.nky),
                      big), big


def _from_work_grid(stack_g, grid, work_grid, dealias):
    pk = sp.to_spectral(stack_g, work_grid)
    if not dealias:
        return pk
    return sp._unpad_spectrum(pk, grid, work_grid.nx) * sp._gt(
        pk, grid).nyquist_mask


def rsw_rhs(Sk, grid: SpectralGrid, p: RSWParams, UV=None):
    """Spectral RHS. UV=None: nonlinear swk form (swk.m:201-217);
    UV=(U, V) grid fields of the prescribed background: linearized swkU
    conservative form (swkU.m:216-246), taken to the state's real dtype.

    Returns (Rk (3, nx, nky), umax, divk): umax is the grid-space
    max(|u|, |v|) (a 0-dim device tensor) needed for the Courant
    condition, computed here where the grid fields already exist; divk
    the divergence spectrum the killpv projection reads.
    """
    uk, vk, hk = Sk[0], Sk[1], Sk[2]
    zk = sp.ddx(vk, grid) - sp.ddy(uk, grid)
    divk = sp.ddx(uk, grid) + sp.ddy(vk, grid)

    if UV is None:
        fields, wg = _to_work_grid(torch.stack([uk, vk, hk, zk]), grid,
                                   p.dealias)
        u, v, h, zeta = fields
        umax = torch.maximum(torch.max(torch.abs(u)), torch.max(torch.abs(v)))
        bfac = 0.5 if p.bernoulli_half else 1.0
        prods = torch.stack([v * zeta, u * zeta, bfac * (u * u + v * v),
                             u * h, v * h])
        vz_k, uz_k, ke_k, uh_k, vh_k = _from_work_grid(prods, grid, wg,
                                                       p.dealias)
        Bk = ke_k + p.Cg**2 * hk
        Ru = vz_k + p.f * vk - sp.ddx(Bk, grid)
        Rv = -uz_k - p.f * uk - sp.ddy(Bk, grid)
        Rh = -sp.ddx(uh_k, grid) - sp.ddy(vh_k, grid) - divk
    else:
        rd = sp._real_dtype(Sk)
        U, V = (a.to(dtype=rd) for a in UV)
        fields, wg = _to_work_grid(torch.stack([uk, vk, hk, divk]), grid,
                                   p.dealias)
        u, v, h, divu = fields
        umax = torch.maximum(torch.max(torch.abs(u)), torch.max(torch.abs(v)))
        Ug, Vg = _to_work_grid(sp.to_spectral(torch.stack([U, V]), grid),
                               grid, p.dealias)[0]
        prods = torch.stack([Ug * u, Vg * u + v * Ug, Ug * divu,
                             Ug * v + u * Vg, Vg * v, Vg * divu,
                             Ug * h, Vg * h])
        (Uu_k, VuvU_k, Udiv_k, UvuV_k, Vv_k, Vdiv_k, Uh_k,
         Vh_k) = _from_work_grid(prods, grid, wg, p.dealias)
        Ru = (-2.0 * sp.ddx(Uu_k, grid) - sp.ddy(VuvU_k, grid) + Udiv_k
              + p.f * vk - p.Cg**2 * sp.ddx(hk, grid))
        Rv = (-sp.ddx(UvuV_k, grid) - 2.0 * sp.ddy(Vv_k, grid) + Vdiv_k
              - p.f * uk - p.Cg**2 * sp.ddy(hk, grid))
        Rh = -sp.ddx(Uh_k, grid) - sp.ddy(Vh_k, grid) - divk
    return torch.stack([Ru, Rv, Rh]), umax, divk


def _killpv_project(Sk, divk, grid: SpectralGrid, p: RSWParams):
    """Reset vorticity to f*h keeping divergence (swkU.m:193-197). Uses
    the PRE-update divergence, as the reference's stale global does."""
    K2 = sp._gt(Sk, grid).K2
    Km2 = 1.0 / torch.where(K2 == 0, torch.inf, K2)
    hk = Sk[2]
    uk = -Km2 * (sp.ddx(divk, grid) - p.f * sp.ddy(hk, grid))
    vk = -Km2 * (sp.ddy(divk, grid) + p.f * sp.ddx(hk, grid))
    return torch.stack([uk, vk, hk])


def _pv_damp(Sk, grid: SpectralGrid, p: RSWParams):
    """Relax out the residual (unbalanced) PV (swkUqx.m:243-262):
    pv_res = zeta - f h; psi_res = pv_res_k / (-(Cg^2/f) K2 - f);
    subtract rate * (u_res, v_res, psi_res)."""
    uk, vk, hk = Sk[0], Sk[1], Sk[2]
    zk = sp.ddx(vk, grid) - sp.ddy(uk, grid)
    pvk = zk - p.f * hk
    denom = -(p.Cg**2 / p.f) * sp._gt(Sk, grid).K2 - p.f
    psik = pvk / denom
    c = p.Cg**2 / p.f
    u_res = -c * sp.ddy(psik, grid)
    v_res = c * sp.ddx(psik, grid)
    r = p.pv_damp_rate
    return torch.stack([uk - r * u_res, vk - r * v_res, hk - r * psik])


# ---------------------------------------------------------------------------
# Stepping
# ---------------------------------------------------------------------------

_AB3 = (23.0 / 12.0, -16.0 / 12.0, 5.0 / 12.0)  # Durran 3.81 (swk.m:116)


def _filter_tensors(filters, Sk):
    """(fU, fR) in the state's real dtype on its device (no copy when
    they already are)."""
    rd = sp._real_dtype(Sk)
    return tuple(as_tensor(a, rd, Sk.device) for a in filters)


def rsw_step(state: RSWState, grid: SpectralGrid, p: RSWParams, filters,
             UV=None) -> RSWState:
    """One AB3 + trapezoidal-filter step (swk.m:130-193). `filters` is
    rsw_filters' pair, as numpy arrays or (cheaper, as simulate_rsw passes
    them) as tensors of the state's dtype on its device. Reads nothing
    back to the host."""
    fU, fR = _filter_tensors(filters, state.Sk)
    Rk, umax, divk = rsw_rhs(state.Sk, grid, p, UV)

    if state.step == 0:
        Rm1 = Rm2 = Rk
    else:
        Rm1, Rm2 = state.rhs_m1, state.rhs_m2

    umax = torch.clamp_min(umax, p.Cmax)
    blown = state.blown | (umax > 1e6)
    dt = torch.where(blown, 0.0, p.dttune * grid.dx / umax)

    a1, a2, a3 = _AB3
    Sk = fU * state.Sk + dt * fR * (a1 * Rk + a2 * Rm1 + a3 * Rm2)
    if p.killpv:
        Sk = _killpv_project(Sk, divk, grid, p)
    if p.pv_damp_rate:
        Sk = _pv_damp(Sk, grid, p)
    return RSWState(Sk=Sk, rhs_m1=Rk, rhs_m2=Rm1, t=state.t + dt, dt=dt,
                    step=state.step + 1, blown=blown)


def simulate_rsw(state: RSWState, grid: SpectralGrid, p: RSWParams,
                 nsteps: int, save_every: int = 1,
                 background_fn: Callable | None = None, Xp0=None,
                 particle_vel_scale: float = 1.0):
    """Run nsteps, saving (u, v, h) grids + (t, ke, pe) per frame. Runs on
    the device of the state and reads nothing back to the host.

    background_fn: optional t -> (U, V) grid fields for the linearized
    solvers (t the state's 0-dim float64 time); a time-dependent callable
    gives swkU_tc, a constant closure gives swkU, None gives nonlinear swk.

    Xp0: optional (2, Np) Lagrangian particle positions (numpy or tensor)
    advected one RK4 step per flow step in the post-step velocity
    (swk.m:184-186, swknd.m np^2 option); particle frames are appended to
    the returns. particle_vel_scale rescales the advecting velocity (the
    swknd change of variables needs dx/dT = u/(gam*ep) — see swknd below).

    Returns (state, S_frames (nf, 3, nx, ny), t (nf,) float64, ke (nf,),
    pe (nf,)[, Xp (nf, 2, Np)]), all on the state's device.
    """
    filters = _filter_tensors(rsw_filters(grid, p), state.Sk)
    nframes = nsteps // save_every
    has_p = Xp0 is not None
    xp = (as_tensor(Xp0, sp._real_dtype(state.Sk), state.Sk.device)
          if has_p else None)
    frames = []
    for _ in range(nframes):
        for _ in range(save_every):
            UV = background_fn(state.t) if background_fn is not None else None
            state = rsw_step(state, grid, p, filters, UV)
            if has_p:
                uv = sp.to_grid(state.Sk[:2], grid)
                xp = advect_particles(xp, particle_vel_scale * uv[0],
                                      particle_vel_scale * uv[1], grid,
                                      state.dt)
        S = sp.to_grid(state.Sk, grid)
        ke, pe = energy(S[0], S[1], S[2], p)
        frames.append((S, state.t, ke, pe, xp))
    if frames:
        S_frames, ts, kes, pes = (torch.stack([fr[i] for fr in frames])
                                  for i in range(4))
        xps = torch.stack([fr[4] for fr in frames]) if has_p else None
    else:
        rd, dev = sp._real_dtype(state.Sk), state.Sk.device
        S_frames = torch.zeros((0, 3) + grid.shape, dtype=rd, device=dev)
        ts = torch.zeros(0, dtype=torch.float64, device=dev)
        kes = pes = torch.zeros(0, dtype=rd, device=dev)
        xps = xp.new_zeros((0,) + xp.shape) if has_p else None
    if has_p:
        return state, S_frames, ts, kes, pes, xps
    return state, S_frames, ts, kes, pes


def swknd(u0, v0, h0, ep: float, gam: float, nsteps: int,
          save_every: int = 1, nutune: float = 1.0, np_particles: int = 0,
          dttune: float = 0.1, dealias: bool = True, *, device=None,
          dtype: torch.dtype = torch.float32):
    """Nondimensional RSW (rsw/swknd.m:1-45):
        u_t = v(1 + ep zeta) - B_x + nu del^a u
        v_t = -u(1 + ep zeta) - B_y + nu del^a v
        h_t = -gam [(1+ep h) u]_x - gam [(1+ep h) v]_y
    with B = gam [ep (u^2+v^2)/2 + h], ep = U/(f Ld), gam = Ld/L.

    Solved by exact change of variables into the dimensional swk core
    (term-by-term match of swknd.m getrhs:197-212 against swk.m getrhs):
        U = gam u,  V = gam v,  H = ep h,  T = ep t,
        f = 1/ep,   Cg = gam/ep
    Differences kept from swk's machinery, as in the JAX package: the
    trapezoidal filter applies to u,v only (swknd.m:178 filters all three
    layers), the adaptive dt/nu are computed in mapped variables, and
    dttune defaults to 0.1 rather than swknd.m's 0.5 (:47), at which AB3 is
    linearly unstable for the fastest gravity wave at 64^2.

    np_particles > 0 advects an np^2 uniform particle grid
    (swknd.m:103-109,181-183); dx/dt_nd = u means dx/dT = u/(gam ep) in
    mapped time, hence the velocity rescale.

    Runs on `device` (None = the CUDA device; raises when there is none)
    in `dtype`. Returns (S_frames (nf, 3, nx, ny) in swknd variables, t
    (swknd time), ke, pe, Xp (nf, 2, np^2) or None) with the
    swknd.m:158-159 energy definitions ke = sum(.5 (1+ep h)(u^2+v^2)),
    pe = sum(.5/ep^2 (1+ep h)^2).
    """
    device = resolve_device(device)
    u0, v0, h0 = (as_tensor(a, dtype, device) for a in (u0, v0, h0))
    nx = u0.shape[0]
    grid = SpectralGrid.square(nx, 2.0 * np.pi)
    p = RSWParams(f=1.0 / ep, Cg=gam / ep, nutune=nutune, dttune=dttune,
                  dealias=dealias)
    st = rsw_init(gam * u0, gam * v0, ep * h0, grid, p, device=device,
                  dtype=dtype)
    if np_particles:
        x0 = (np.arange(np_particles) / np_particles) * grid.Lx + 1e-7
        X, Y = np.meshgrid(x0, x0, indexing="ij")
        xp0 = np.stack([X.ravel(), Y.ravel()])
        st, S, ts, _, _, xps = simulate_rsw(
            st, grid, p, nsteps, save_every, Xp0=xp0,
            particle_vel_scale=1.0 / (gam * ep))
    else:
        st, S, ts, _, _ = simulate_rsw(st, grid, p, nsteps, save_every)
        xps = None
    # back to swknd variables: u = U/gam, h = H/ep, t = T/ep
    S_nd = torch.cat([S[:, :2] / gam, S[:, 2:] / ep], dim=1)
    u, v, h = S_nd[:, 0], S_nd[:, 1], S_nd[:, 2]
    ke = 0.5 * torch.sum((1 + ep * h) * (u**2 + v**2), dim=(1, 2))
    pe = 0.5 / ep**2 * torch.sum((1 + ep * h) ** 2, dim=(1, 2))
    return S_nd, ts / ep, ke, pe, xps


def energy(u, v, h, p: RSWParams):
    """KE/PE diagnostics (swk.m:157-158): ke = mean((1+h)(u^2+v^2))/2,
    pe = Cg^2 mean(h^2)/2."""
    ke = 0.5 * torch.mean((1.0 + h) * (u * u + v * v))
    pe = 0.5 * p.Cg**2 * torch.mean(h * h)
    return ke, pe


def advect_particles(xp, u, v, grid: SpectralGrid, dt):
    """RK4 particle advection in the gridded (u, v) — the function
    swk.m:185 calls but the reference never defines. xp: (2, Np)
    coordinate-first (ops/interp.py); dt a float or a 0-dim tensor."""
    uv = torch.stack([u, v])

    def vel(x):
        return interpolate_stack(uv, x[0], x[1], grid)

    k1 = dt * vel(xp)
    k2 = dt * vel(xp + 0.5 * k1)
    k3 = dt * vel(xp + 0.5 * k2)
    k4 = dt * vel(xp + k3)
    return xp + (k1 + 2 * k2 + 2 * k3 + k4) / 6.0


# ---------------------------------------------------------------------------
# Diagnostics (rsw/getswpv.m, rsw/wavevortdecomp.m)
# ---------------------------------------------------------------------------

def potential_vorticity(u, v, h, grid: SpectralGrid, p: RSWParams):
    """(zeta, q, qlin) per rsw/getswpv.m:16-20: q = (zeta + f)/(1 + h),
    qlin = zeta - f h."""
    Sk = sp.to_spectral(torch.stack([u, v]), grid)
    zeta = sp.to_grid(sp.ddx(Sk[1], grid) - sp.ddy(Sk[0], grid), grid)
    q = (zeta + p.f) / (1.0 + h)
    qlin = zeta - p.f * h
    return zeta, q, qlin


def wave_vortex_decompose(u, v, h, grid: SpectralGrid, p: RSWParams):
    """Linear wave/vortex splitting of (u, v, h) (rsw/wavevortdecomp.m
    method): project each spectral mode onto the vortical (geostrophic)
    eigenvector; the remainder is the wave part. Returns
    ((ug, vg, hg), (uw, vw, hw)) on the device of u."""
    f, C = p.f, p.Cg
    gt = sp._gt(u, grid)
    kx, ky, K2 = gt.kx, gt.ky, gt.K2
    W2 = f**2 + C**2 * K2

    Sk = sp.to_spectral(torch.stack([u, v, C * h]), grid)
    uk, vk, chk = Sk[0], Sk[1], Sk[2]
    # vortical eigenvector V0 = (-i l C, i k C, f); |V0|^2 = W^2
    proj = (torch.conj(-1j * ky * C) * uk + torch.conj(1j * kx * C) * vk
            + f * chk) / W2
    ugk = proj * (-1j * ky * C)
    vgk = proj * (1j * kx * C)
    hgk = proj * f
    G = sp.to_grid(torch.stack([ugk, vgk, hgk]), grid)
    ug, vg, hg = G[0], G[1], G[2] / C
    return (ug, vg, hg), (u - ug, v - vg, h - hg)


def wave_vortex_spectra(u, v, h, grid: SpectralGrid, p: RSWParams):
    """Isotropic KE/PE spectra of the wave and vortex parts — the
    rsw/wavevortdecomp.m:24-55 diagnostics (it calls `iso_spectra`,
    which the reference does not ship; ops.spectral.isospectrum is the
    shipped isospectrum applied per energy density here).

    Returns dict with 'ke_g', 'pe_g', 'ke_w', 'pe_w', each (kmax,)."""
    (ug, vg, hg), (uw, vw, hw) = wave_vortex_decompose(u, v, h, grid, p)

    def spec2(a, b=None):
        d = torch.abs(sp.to_spectral(a, grid)) ** 2
        if b is not None:
            d = d + torch.abs(sp.to_spectral(b, grid)) ** 2
        return sp.isospectrum(d, grid)

    return {
        "ke_g": 0.5 * spec2(ug, vg),
        "pe_g": 0.5 * p.Cg**2 * spec2(hg),
        "ke_w": 0.5 * spec2(uw, vw),
        "pe_w": 0.5 * p.Cg**2 * spec2(hw),
    }
