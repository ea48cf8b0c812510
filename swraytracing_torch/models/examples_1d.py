"""Canned 1-D experiment ICs + drift theory.

Counterpart of swraytracing_tpu/models/examples_1d.py, numpy on the host
as there: the reference's 1-D example family (rsw/sw1examples.m:1-27
geostrophic jump; rsw/planewave1d.m:1-34 plane wave + particles + Stokes
theory; rsw/sw1setup.m:1-29 the (Ro, Bu) plane wave for sw1rk3nu).

These are IC functions, not scripts: each returns (x, U0) ready for the
models.sw1d solvers, and the drift/oscillation theory lines the
reference scripts overlay on their figures are provided as functions so
tests can assert them (planewave1d.m's exact-plane-wave-vs-solver check
is held by the JAX package's tests with exact_linear.linear_sw_solution_1d
as the oracle).
"""

from __future__ import annotations

import numpy as np

__all__ = ["grid_1d", "plane_wave_1d", "geostrophic_jump_1d",
           "sw1setup_wave", "stokes_drift_1d", "eulerian_mean_1d"]


def grid_1d(nx: int, centered: bool = True):
    """The reference's 1-D periodic grid on L = 2*pi
    (planewave1d.m:4-6): x_i = i*dx - L/2 (centered=True) or i*dx
    (sw1setup.m:5-6)."""
    x = 2.0 * np.pi * np.arange(nx) / nx
    return x - np.pi if centered else x


def plane_wave_1d(nx: int, f: float, Cg: float, a: float, k0: int):
    """Exact linear plane-wave IC (planewave1d.m:21-23; also the
    sw1examples.m "Plane gravity wave" blocks at :100-106, :140-146):

        u = a * (wp/k0) cos(k0 x),  v = a * (f/k0) sin(k0 x),
        h = a * cos(k0 x),          wp = sqrt(f^2 + Cg^2 k0^2)

    which solves the LINEAR 1-D RSW exactly as a wave translating at
    c = wp/k0; running it through the nonlinear sw1 solver at small `a`
    is the reference's solver-vs-exact-solution check.

    Returns (x, U0 (nx, 3))."""
    x = grid_1d(nx)
    wp = np.sqrt(f**2 + Cg**2 * k0**2)
    U0 = np.stack([a * wp / k0 * np.cos(k0 * x),
                   a * f / k0 * np.sin(k0 * x),
                   a * np.cos(k0 * x)], axis=1)
    return x, U0


def geostrophic_jump_1d(nx: int, f: float, Cg: float, h0: float):
    """Localized geostrophic jump (sw1examples.m:17-23): h = h0 * x /
    (x^4 + .01), v = (Cg^2/f) h_x (spectral derivative, dxk.m), u = 0.
    PV = (f + v_x)/(1 + h) is NOT uniform here despite the file's
    comment sketch — what the block actually relies on is that a
    u = 0 geostrophically balanced state is an exact steady solution of
    the 1-D equations ("geostrophically balanced flows in 1D don't
    evolve at all", sw1examples.m:12): every tendency term in sw1_rhs
    carries a factor of u or (f v - Cg^2 h_x).

    Returns (x, U0 (nx, 3))."""
    x = grid_1d(nx)
    h = h0 * x / (x**4 + 0.01)
    hk = np.fft.rfft(h)
    k = np.arange(hk.shape[0])
    v = Cg**2 / f * np.fft.irfft(1j * k * hk, nx)
    U0 = np.stack([np.zeros(nx), v, h], axis=1)
    return x, U0


def sw1setup_wave(n: int = 6, etahat: float = 0.05, Bu: float = 1.0,
                  k: int = 4):
    """sw1setup.m:1-21: the (Ro, Bu)-nondimensional plane wave for
    sw1rk3nu — NX = 2^(n+1) points on [0, 2*pi),
    w = sqrt(1 + Bu k^2), c = w/k:

        u = c * etahat * cos(k x), v = (etahat/k) sin(k x),
        h = etahat * cos(k x)

    Returns (x, U0 (NX, 3))."""
    NX = 2 ** (n + 1)
    x = grid_1d(NX, centered=False)
    w = np.sqrt(1.0 + Bu * k**2)
    c = w / k
    U0 = np.stack([c * etahat * np.cos(k * x),
                   etahat / k * np.sin(k * x),
                   etahat * np.cos(k * x)], axis=1)
    return x, U0


def stokes_drift_1d(a: float, k0: int, f: float, Cg: float) -> float:
    """Mean Stokes drift velocity of the plane wave
    (planewave1d.m:80: us = a^2 * wp / (2 k0))."""
    return a**2 * np.sqrt(f**2 + Cg**2 * k0**2) / (2.0 * k0)


def eulerian_mean_1d(t, a: float, k0: int, f: float, Cg: float):
    """Theory line for the wave-driven Eulerian mean flow
    (planewave1d.m:81: ueth = a^2 (wp/(2 k0)) (cos(f t) - 1)) — the
    inertial-oscillation response that cancels the Stokes drift's mean
    in the rotating case (the file's "it's just the IO term" note)."""
    wp = np.sqrt(f**2 + Cg**2 * k0**2)
    return a**2 * wp / (2.0 * k0) * (np.cos(f * np.asarray(t)) - 1.0)
