"""Canned initial conditions for the RSW solvers.

Counterpart of swraytracing_tpu/models/examples.py, the reference's
experiment library (rsw/swexamples.m eight cases, wavespecic2d.m wave-bath
+ narrow-band geostrophic spectra, dopplerwave.m-style superpositions,
run_swkU.m / input_sw_tc.m setups), with the same numpy random streams
(``np.random.default_rng(seed)``).

Every IC function returns (u, v, h) numpy grids ready for rsw.rsw_init: ICs
are built once, on the host, in float64. The IC functions that need a spectral
transform run the port's ops/spectral on float64 CPU tensors for it. The
one exception is `translating_cs_background`, whose `background_fn(t)` runs
every step of a run and computes on the device of its `t`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.grid import SpectralGrid
from ..ops import spectral as sp
from .exact_linear import plane_wave_ic, geostrophic_ic

__all__ = [
    "wave_packet_ic",
    "zero_pv_adjustment_ic",
    "rigid_lid_vortex_ic",
    "inertial_oscillation_ic",
    "counter_propagating_ic",
    "wave_bath_ic",
    "wave_and_geostrophic_spectrum_ic",
    "translating_cs_background",
    "doppler_wave_field",
    "doppler_refract_wave_field",
    "doppler_refract_wave_sw",
]


def wave_packet_ic(grid: SpectralGrid, f: float, Cg: float, h0=0.1,
                   k0: int = 5, theta: float = 0.0, x0=np.pi / 6,
                   y0=-np.pi / 4, width: float = 10.0):
    """Gaussian-envelope gravity-wave packet oriented by theta
    (swexamples.m case 1, :15-34)."""
    X, Y = grid.meshgrid()
    Xc = X - grid.Lx / 2
    Yc = Y - grid.Ly / 2
    xp = Xc * np.cos(theta) - Yc * np.sin(theta)
    yp = Xc * np.sin(theta) + Yc * np.cos(theta)
    w = -np.sqrt(f**2 + Cg**2 * k0**2)
    env = np.exp(-((width * (xp - x0) / grid.Lx) ** 2)
                 - (width * (yp - y0) / grid.Ly) ** 2)
    u = h0 * w / k0 * env * np.cos(k0 * Xc)
    v = h0 * f / k0 * env * np.sin(k0 * Xc)
    h = h0 * env * np.cos(k0 * xp)
    return u, v, h


def zero_pv_adjustment_ic(grid: SpectralGrid, f: float, Cg: float,
                          h0=0.01, b: float = 10.0):
    """Localized surface jump with vorticity = f*h so PV is uniform —
    geostrophic adjustment radiates the imbalance away (swexamples.m
    case 2, :44-63)."""
    X, Y = grid.meshgrid()
    Xc = X - grid.Lx / 2
    Yc = Y - grid.Ly / 2
    env = np.exp(-((b * Yc / grid.Ly) ** 2))
    h = h0 * env * Xc / (Xc**4 + 0.01)
    K2 = np.where(grid.K2 == 0, np.inf, grid.K2)
    psik = -sp.to_spectral(_host(h), grid) / _host(K2)
    u = f * sp.to_grid(-sp.ddy(psik, grid), grid)
    v = f * sp.to_grid(sp.ddx(psik, grid), grid)
    return u.numpy(), v.numpy(), h


def rigid_lid_vortex_ic(grid: SpectralGrid, f: float, Cg: float,
                        A: float = 0.1, sigma: float = 0.5):
    """Geostrophically balanced Gaussian vortex (swexamples.m rigid-lid
    vortex case): psi Gaussian, h = f psi / Cg^2."""
    X, Y = grid.meshgrid()
    r2 = (X - grid.Lx / 2) ** 2 + (Y - grid.Ly / 2) ** 2
    psi = A * np.exp(-r2 / (2 * sigma**2))
    return geostrophic_ic(grid, f, Cg, psi)


def inertial_oscillation_ic(grid: SpectralGrid, u0: float = 0.1):
    """Uniform velocity, flat surface: rotates at exactly f
    (swexamples.m inertial oscillation case)."""
    z = np.zeros(grid.shape)
    return u0 + z, z.copy(), z.copy()


def counter_propagating_ic(grid: SpectralGrid, f: float, Cg: float,
                           k_int: int = 4, eta0: float = 0.02):
    """Two equal waves with opposite propagation directions — a standing
    oscillation (swexamples.m counter-propagating pair; cf.
    rsw/standingwave.m)."""
    u1, v1, h1 = plane_wave_ic(grid, f, Cg, k_int, 0, eta0, sign=+1)
    u2, v2, h2 = plane_wave_ic(grid, f, Cg, -k_int, 0, eta0, sign=+1)
    return u1 + u2, v1 + v2, h1 + h2


def wave_bath_ic(grid: SpectralGrid, f: float, Cg: float, aw: float = 0.1,
                 k_max_wave: int = 5, seed: int = 0):
    """Random-phase spectrum of gravity waves with random frequency
    branches, |k| <= k_max_wave (wavespecic2d.m:24-40; also the wave
    bath of input_sw_tc.m). Amplitude scaled so max|h| = aw."""
    rng = np.random.default_rng(seed)
    u = np.zeros(grid.shape)
    v = np.zeros_like(u)
    h = np.zeros_like(u)
    for k in range(-grid.kmax, grid.kmax + 1):
        for l in range(0, grid.kmax + 1):
            K2 = k * k + l * l
            if K2 == 0 or K2 > k_max_wave**2:
                continue
            sign = 1 if rng.random() > 0.5 else -1
            ui, vi, hi = plane_wave_ic(grid, f, Cg, k, l, 1.0, sign=sign,
                                       phase=rng.uniform(0, 2 * np.pi))
            u += ui
            v += vi
            h += hi
    s = aw / max(np.abs(h).max(), 1e-30)
    return s * u, s * v, s * h


def wave_and_geostrophic_spectrum_ic(grid: SpectralGrid, f: float,
                                     Cg: float, aw: float = 0.1,
                                     ag: float = 0.3, k_max_wave: int = 5,
                                     k_geo_lo: int = 10,
                                     k_geo_hi: int = 13, seed: int = 0):
    """Wave bath + narrow-band random-phase geostrophic flow
    (wavespecic2d.m, the run_swkU.m configuration). Returns
    ((u, v, h) total, (ug, vg, hg) geostrophic part)."""
    rng = np.random.default_rng(seed)
    uw, vw, hw = wave_bath_ic(grid, f, Cg, aw, k_max_wave, seed)
    X, Y = grid.meshgrid()
    psi = np.zeros(grid.shape)
    for k in range(-grid.kmax, grid.kmax + 1):
        for l in range(0, grid.kmax + 1):
            K2 = k * k + l * l
            if not (k_geo_lo**2 < K2 <= k_geo_hi**2):
                continue
            phi = rng.uniform(0, 2 * np.pi)
            psi += np.cos((2 * np.pi / grid.Lx) * k * X
                          + (2 * np.pi / grid.Ly) * l * Y + phi) / max(K2, 1)
    ug, vg, hg = geostrophic_ic(grid, f, Cg, psi)
    smax = np.sqrt(ug**2 + vg**2).max()
    s = ag / max(smax, 1e-30)
    ug, vg, hg = s * ug, s * vg, s * hg
    return (uw + ug, vw + vg, hw + hg), (ug, vg, hg)


def translating_cs_background(grid: SpectralGrid, f: float, Cg: float,
                              ag: float = 0.2, km: int = 1,
                              a_cs: float = 0.25, raXT: float = 0.1):
    """Time-dependent background (U, V) from a translating
    Childress-Soward streamfunction — the swkU_tc configuration
    (rsw/swkU_tc.m:202-220): Psi translates in both x and y at rate raXT;
    amplitude normalised so max|Psi| = ag each step.

    Returns background_fn(t) -> (U, V) grids for rsw.simulate_rsw. `t` is
    a 0-dim tensor (simulate_rsw passes the state's float64 time); the
    grids are computed on its device and in its dtype, the normalisation
    max|Psi| a reduction there, so a step reads nothing back to the host.
    """
    X, Y = grid.meshgrid()
    scale = Cg**2 / f
    coords: dict = {}

    def psi_at(t):
        key = (t.device, t.dtype)
        if key not in coords:
            coords[key] = tuple(torch.as_tensor(a, dtype=t.dtype,
                                                device=t.device)
                                for a in (X, Y))
        Xt, Yt = coords[key]
        xs = km * (Xt - t * raXT)
        ys = km * (Yt - t * raXT)
        psi = scale * (torch.sin(xs) * torch.sin(ys)
                       + a_cs * torch.cos(xs) * torch.cos(ys))
        return ag * psi / torch.max(torch.abs(psi))

    def background_fn(t):
        psik = sp.to_spectral(psi_at(t), grid)
        U = sp.to_grid(-sp.ddy(psik, grid), grid)
        V = sp.to_grid(sp.ddx(psik, grid), grid)
        return U, V

    return background_fn


def _cs_geostrophic(grid: SpectralGrid, f: float, C0: float, ag: float,
                    a_cs: float, km: int):
    """Childress-Soward geostrophic flow on centered coordinates
    (dopplerwave.m:22-28 / dopplerrefractwave.m:26-31). Returns
    (ug, vg, etag, vortg, Xc, Yc); vortg uses the reference's shortcut
    vortg = -2 km^2 etag (dopplerrefractwave.m:31) — this equals
    (f/C0^2) * the true geostrophic vorticity laplacian(C0^2/f etag),
    i.e. the true vorticity only when C0^2 = f... we keep the
    reference's field since the refraction formula was tuned to it."""
    X, Y = grid.meshgrid()
    Xc = X - grid.Lx / 2
    Yc = Y - grid.Ly / 2
    etag = ag * (np.sin(km * Xc) * np.sin(km * Yc)
                 + a_cs * np.cos(km * Xc) * np.cos(km * Yc))
    ug = -ag * km * C0**2 / f * (np.sin(km * Xc) * np.cos(km * Yc)
                                 - a_cs * np.cos(km * Xc) * np.sin(km * Yc))
    vg = ag * km * C0**2 / f * (np.cos(km * Xc) * np.sin(km * Yc)
                                - a_cs * np.sin(km * Xc) * np.cos(km * Yc))
    vortg = -2.0 * km**2 * etag
    return ug, vg, etag, vortg, Xc, Yc


def _wave_superposition(grid: SpectralGrid, f: float, C0: float, times,
                        ug, vg, omega2_field, k_range, l_range, aw: float,
                        seed: int, Xc, Yc):
    """Sum of onewave.m linear modes with Doppler (and optionally
    refraction, via omega2_field = f(f+vortg)) corrections; the wave
    part is renormalised at EVERY time so max|etaw| = aw
    (dopplerwave.m:71-74 — the reference renormalises inside its movie
    loop). Returns (uw, vw, etaw) each (nt, nx, ny)."""
    rng = np.random.default_rng(seed)
    times = np.atleast_1d(np.asarray(times, dtype=float))
    nt = len(times)
    uw = np.zeros((nt,) + grid.shape)
    vw = np.zeros_like(uw)
    etaw = np.zeros_like(uw)
    for k in k_range:
        for l in l_range:
            K2 = k * k + l * l
            phi = rng.uniform(0, 2 * np.pi)
            sgn = 1.0 if rng.random() > 0.5 else -1.0
            # omega may be a FIELD (refraction by mean-flow vorticity:
            # dopplerrefractwave.m:63) or a constant (dopplerwave.m:63)
            w = sgn * np.sqrt(omega2_field + C0**2 * K2)
            for it, t in enumerate(times):
                theta = (k * Xc + l * Yc + phi - (w + k * ug + l * vg) * t)
                ct, st = np.cos(theta), np.sin(theta)
                etaw[it] += ct
                uw[it] += (k * w * ct - l * f * st) / K2
                vw[it] += (l * w * ct + k * f * st) / K2
    emax = np.abs(etaw).max(axis=(1, 2), keepdims=True)
    emax = np.where(emax == 0, 1.0, emax)
    return aw * uw / emax, aw * vw / emax, aw * etaw / emax


def doppler_wave_field(grid: SpectralGrid, f: float, C0: float, times,
                       ag: float = 0.2, aw: float = 0.1, a_cs: float = 0.25,
                       km: int = 1, k_range=range(3, 11),
                       l_range=range(5, 11), seed: int = 0):
    """Linear wave superposition Doppler-shifted by a steady CS
    geostrophic flow, neglecting refraction
    (rsw/dopplerwave.m): each mode advances with local
    phase theta = k x + l y + phi - (omega + k U_g + l V_g) t, with
    omega = sign*sqrt(f^2 + C0^2 K^2) constant per mode, and the full
    onewave.m (u, v, eta) polarisation.

    Returns ((u, v, eta) totals each (nt, nx, ny), geostrophic
    (ug, vg, etag), ew (nt,) wave energy sum(uw^2+vw^2+C0^2 etaw^2) —
    dopplerwave.m:77-79)."""
    ug, vg, etag, _, Xc, Yc = _cs_geostrophic(grid, f, C0, ag, a_cs, km)
    uw, vw, etaw = _wave_superposition(grid, f, C0, times, ug, vg, f**2,
                                       k_range, l_range, aw, seed, Xc, Yc)
    ew = np.sum(uw**2 + vw**2 + C0**2 * etaw**2, axis=(1, 2))
    return (ug + uw, vg + vw, etag + etaw), (ug, vg, etag), ew


def doppler_refract_wave_field(grid: SpectralGrid, f: float, C0: float,
                               times, ag: float = 0.2, aw: float = 0.1,
                               a_cs: float = 0.25, km: int = 1,
                               k_range=range(3, 11), l_range=range(5, 11),
                               seed: int = 0):
    """dopplerwave with refraction by the mean-flow vorticity
    (rsw/dopplerrefractwave.m:63): the local intrinsic
    frequency becomes omega^2 = f(f + vortg) + C0^2 K^2, so wave crests
    bend through the CS cells. Returns ((u, v, eta) totals,
    (ug, vg, etag, vortg))."""
    ug, vg, etag, vortg, Xc, Yc = _cs_geostrophic(grid, f, C0, ag, a_cs, km)
    uw, vw, etaw = _wave_superposition(grid, f, C0, times, ug, vg,
                                       f * (f + vortg), k_range, l_range,
                                       aw, seed, Xc, Yc)
    return (ug + uw, vg + vw, etag + etaw), (ug, vg, etag, vortg)


def doppler_refract_wave_sw(u, v, eta, grid: SpectralGrid, f: float,
                            Cg: float, times, ag: float = 0.2,
                            aw: float = 0.1, k_range=range(3, 11),
                            l_range=range(5, 11), seed: int = 0):
    """dopplerrefractwave over a geostrophic flow EXTRACTED from an RSW
    state (rsw/dopplerrefractwave_sw.m:10-50): project
    (u, v, eta) onto the geostrophic mode
    eta_g,k = (f eta_k - zeta_k) f / (f^2 + gH0 K^2), renormalise
    max|etag| = ag, rebuild (ug, vg, vortg) spectrally, then superpose
    the refracted wave bath. (u, v, eta) is e.g. a restart frame from a
    wavevort RSW run. Returns ((u, v, eta) totals, (ug, vg, etag,
    vortg))."""
    gH0 = Cg**2
    S = sp.to_spectral(torch.stack([_host(u), _host(v), _host(eta)]), grid)
    uk, vk, etak = S[0], S[1], S[2]
    gt = grid.tensors("cpu", torch.float64)
    kx, ky, K2 = gt.kx, gt.ky, gt.K2
    sig2 = f**2 + gH0 * K2
    zetak = 1j * (kx * vk - ky * uk)
    etagk = (f * etak - zetak) * f / sig2
    etag = sp.to_grid(etagk, grid)
    scale = ag / torch.max(torch.abs(etag))
    etagk = etagk * scale
    ugk = -1j * ky * (gH0 / f) * etagk
    vgk = 1j * kx * (gH0 / f) * etagk
    zetagk = -(gH0 / f) * etagk * K2
    G = sp.to_grid(torch.stack([etagk, ugk, vgk, zetagk]), grid).numpy()
    etag, ug, vg, vortg = G[0], G[1], G[2], G[3]
    X, Y = grid.meshgrid()
    Xc = X - grid.Lx / 2
    Yc = Y - grid.Ly / 2
    uw, vw, etaw = _wave_superposition(grid, f, Cg, times, ug, vg,
                                       f * (f + vortg), k_range, l_range,
                                       aw, seed, Xc, Yc)
    return (ug + uw, vg + vw, etag + etaw), (ug, vg, etag, vortg)


def _host(a) -> torch.Tensor:
    """A float64 CPU tensor of the host array `a` (a tensor comes to the
    host), for the IC functions' spectral transforms."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)
