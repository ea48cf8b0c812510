"""Spectral transform core on ``torch.fft``.

Counterpart of swraytracing_tpu/ops/spectral.py (the reference's g2k /
k2g / fulspec family). Layout: ``rfft2`` half-plane, shape
(nx, ny//2+1). Normalisation matches the reference: forward divides by
nx*ny, inverse multiplies, and the forward transform zeroes the Nyquist
modes. Leading batch dimensions are supported throughout.

Every function runs on the device and in the precision of the tensor it
is given; the grid's wavenumber arrays come from
``grid.tensors(device, dtype)``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .grid import SpectralGrid

__all__ = [
    "to_spectral",
    "to_grid",
    "ddx",
    "ddy",
    "enforce_hermitian",
    "refspec_to_rfft2",
    "rfft2_to_refspec",
    "exp_filter",
    "padded_grid",
    "padded_product",
    "dealiased_jacobian",
    "isospectrum",
    "to_spectral_1d",
    "to_grid_1d",
    "padded_product_1d",
]


def _real_dtype(t: torch.Tensor) -> torch.dtype:
    if t.dtype in (torch.float64, torch.complex128):
        return torch.float64
    return torch.float32


def _gt(t: torch.Tensor, grid: SpectralGrid):
    return grid.tensors(t.device, _real_dtype(t))


# ---------------------------------------------------------------------------
# Basic transforms (g2k / k2g equivalents)
# ---------------------------------------------------------------------------

def to_spectral(f: torch.Tensor, grid: SpectralGrid) -> torch.Tensor:
    """Grid -> half-plane spectrum; reference g2k (g2k.m:1-10), with
    Nyquist modes zeroed to match the reference's truncated mode set."""
    fk = torch.fft.rfft2(f) / (grid.nx * grid.ny)
    return fk * _gt(f, grid).nyquist_mask


def to_grid(fk: torch.Tensor, grid: SpectralGrid) -> torch.Tensor:
    """Half-plane spectrum -> grid; reference k2g (k2g.m:1-9). Assumes the
    ky=0 column is Hermitian (true for spectra of real fields; use
    enforce_hermitian otherwise)."""
    return torch.fft.irfft2(fk, s=(grid.nx, grid.ny)) * (grid.nx * grid.ny)


def ddx(fk: torch.Tensor, grid: SpectralGrid) -> torch.Tensor:
    """Spectral d/dx (i*kx multiply), cf. rsw/dxk.m."""
    return fk * _gt(fk, grid).ikx


def ddy(fk: torch.Tensor, grid: SpectralGrid) -> torch.Tensor:
    return fk * _gt(fk, grid).iky


def _hermitian_column(col: torch.Tensor) -> torch.Tensor:
    return 0.5 * (col + torch.conj(torch.roll(torch.flip(col, (0,)), 1, 0)))


def enforce_hermitian(fk: torch.Tensor, grid: SpectralGrid) -> torch.Tensor:
    """Project the kx content of the ky=0 (and Nyquist-ky, if present)
    columns onto Hermitian symmetry so irfft2 sees a consistent spectrum.

    The reference builds this symmetry by construction in fulspec.m:16-17;
    here it is needed only when a spectrum is assembled by hand. Returns a
    new tensor; the input is left untouched.
    """
    out = fk.clone()
    out[:, 0] = _hermitian_column(fk[:, 0])
    if grid.ny % 2 == 0:
        out[:, -1] = _hermitian_column(fk[:, -1])
    return out


# ---------------------------------------------------------------------------
# Layout conversion to/from the reference's fftshifted half-plane
# ---------------------------------------------------------------------------

def _refspec_rows(grid: SpectralGrid) -> np.ndarray:
    """rfft2 row of each reference row: kx = -kmax..kmax -> kx mod nx."""
    return np.arange(-grid.kmax, grid.kmax + 1) % grid.nx


def refspec_to_rfft2(fk_ref, grid: SpectralGrid):
    """Convert a reference-layout spectrum (2*kmax+1, kmax+1), kx in
    [-kmax, kmax] (shifted), ky in [0, kmax], into the rfft2 layout.

    Used to ingest spectral .bin frames written by the MATLAB code
    (read_field.m spectral mode: nx == 2*ny - 1). Host numpy, complex128,
    as in the JAX package.
    """
    out = np.zeros(grid.spectral_shape, dtype=np.complex128)
    out[_refspec_rows(grid), : grid.kmax + 1] = np.asarray(fk_ref)
    return out


def rfft2_to_refspec(fk, grid: SpectralGrid):
    """Inverse of refspec_to_rfft2 (for writing reference-compatible
    spectral frames); host numpy, complex128."""
    return np.asarray(fk)[_refspec_rows(grid),
                          : grid.kmax + 1].astype(np.complex128)


# ---------------------------------------------------------------------------
# Spectral filters
# ---------------------------------------------------------------------------

def exp_filter(grid: SpectralGrid, cutoff: float = 0.75 * np.pi,
               decay_width: float = 0.25 * np.pi,
               floor: float = 1e-15) -> np.ndarray:
    """Exponential spectral filter of the reference QG solver
    (qgsw_raytrace.m:222-230): E(k*) = exp(log(floor)/width^4 *
    (k* - kc)^4) for k* >= kc, 1 otherwise, with k* = |k| * dx.

    Returns a host numpy array (nx, nky), float64.
    """
    ikx = np.fft.fftfreq(grid.nx, d=1.0 / grid.nx)[:, None]
    iky = np.arange(grid.nky)[None, :]
    # k* uses the *integer* wavenumber times dx, as the reference's
    # kstar = sqrt((kx*dx)^2+(ky*dx)^2) with integer kx_, ky_ and dx=L/nx.
    kstar = np.sqrt((ikx * (2 * np.pi / grid.nx)) ** 2
                    + (iky * (2 * np.pi / grid.ny)) ** 2)
    const = np.log(floor) / decay_width**4
    ef = np.where(kstar >= cutoff, np.exp(const * (kstar - cutoff) ** 4), 1.0)
    return ef * grid.nyquist_mask


# ---------------------------------------------------------------------------
# Dealiased products (3/2-rule zero padding)
# ---------------------------------------------------------------------------

def _pad_spectrum(fk, grid: SpectralGrid, mx: int, my_half: int):
    """Zero-pad an rfft2 spectrum (..., nx, nky) to (..., mx, my_half)."""
    nx, nky = grid.nx, grid.nky
    out = fk.new_zeros(fk.shape[:-2] + (mx, my_half))
    h = nx // 2
    out[..., :h, :nky] = fk[..., :h, :]
    out[..., mx - h:, :nky] = fk[..., nx - h:, :]
    return out


def _unpad_spectrum(fk_big, grid: SpectralGrid, mx: int):
    nx, nky = grid.nx, grid.nky
    h = nx // 2
    top = fk_big[..., :h, :nky]
    bot = fk_big[..., mx - h:, :nky]
    mid = fk_big.new_zeros(fk_big.shape[:-2] + (nx - 2 * h, nky))
    return torch.cat([top, mid, bot], dim=-2)


@functools.lru_cache(maxsize=64)
def padded_grid(grid: SpectralGrid) -> SpectralGrid:
    """The 3/2-padded companion grid used for dealiased products. One
    object per grid, so its cached device view (grid.tensors) is built
    once: a new grid each call would copy its wavenumber arrays to the
    device, and wait for the copy, at every dealiased product."""
    return SpectralGrid(nx=3 * grid.nx // 2, ny=3 * grid.ny // 2,
                        Lx=grid.Lx, Ly=grid.Ly)


def padded_product(fk, gk, grid: SpectralGrid):
    """Exactly dealiased spectral product: returns the spectrum of f*g.

    Both factors are zero-padded to 3/2 resolution, multiplied on the
    fine grid, and truncated back; quadratic aliasing cancels identically
    (the reference's staggered-grid Orszag machinery, rsw/swk.m:221-263,
    reaches the same result).
    """
    big = padded_grid(grid)
    mx, myh = big.nx, big.nky
    # the 1/N^2 normalisations of the padded transforms cancel through
    # the product
    fbig = to_grid(_pad_spectrum(fk, grid, mx, myh), big)
    gbig = to_grid(_pad_spectrum(gk, grid, mx, myh), big)
    pk = to_spectral(fbig * gbig, big)
    return _unpad_spectrum(pk, grid, mx) * _gt(fk, grid).nyquist_mask


def dealiased_jacobian(ak, bk, grid: SpectralGrid, dealias: bool = True):
    """Spectral Jacobian J(a, b) = a_x b_y - a_y b_x.

    dealias=False reproduces the reference QG solver's plain (aliased)
    pseudo-spectral Jacobian (qgsw_raytrace.m:272-283); True uses the
    3/2-rule product.
    """
    akx, aky = ddx(ak, grid), ddy(ak, grid)
    bkx, bky = ddx(bk, grid), ddy(bk, grid)
    if dealias:
        return padded_product(akx, bky, grid) - padded_product(aky, bkx, grid)
    ax, ay = to_grid(akx, grid), to_grid(aky, grid)
    bx, by = to_grid(bkx, grid), to_grid(bky, grid)
    return to_spectral(ax * by - ay * bx, grid)


# ---------------------------------------------------------------------------
# Diagnostics
# ---------------------------------------------------------------------------

def isospectrum(fk2: torch.Tensor, grid: SpectralGrid) -> torch.Tensor:
    """Azimuthal ring-sum of a half-plane spectral density.

    Reference: rsw/isospectrum.m (which operates on the full plane); here
    the ky>0 half-plane is double-counted to account for the conjugate
    half, matching the full-plane sum for densities of real fields.

    Args:
      fk2: real spectral density on the rfft2 half-plane (e.g. |fk|^2).
    Returns:
      (kmax,) tensor, ring K=1..kmax sums, one index_add_ over the plane.
    """
    ikx = np.fft.fftfreq(grid.nx, d=1.0 / grid.nx)[:, None]
    iky = np.arange(grid.nky)[None, :]
    Kround = np.floor(np.sqrt(ikx**2 + iky**2) + 0.5).astype(np.int64)
    # double-count interior ky>0 columns (conjugate half-plane)
    weight = np.where((iky > 0) & (iky < grid.ny - iky), 2.0, 1.0)
    kmax = grid.kmax
    keep = Kround <= kmax                       # (nx, nky)
    vals = (fk2 * torch.as_tensor(weight, dtype=fk2.dtype,
                                  device=fk2.device))[
        torch.as_tensor(keep, device=fk2.device)]
    bins = torch.as_tensor(Kround[keep], device=fk2.device)
    rings = fk2.new_zeros(kmax + 1).index_add_(0, bins, vals)
    return rings[1:]


# ---------------------------------------------------------------------------
# 1-D transforms (for the sw1/ybj1d family)
# ---------------------------------------------------------------------------

def to_spectral_1d(f: torch.Tensor, n: int) -> torch.Tensor:
    return torch.fft.rfft(f) / n


def to_grid_1d(fk: torch.Tensor, n: int) -> torch.Tensor:
    return torch.fft.irfft(fk, n=n) * n


def padded_product_1d(fk: torch.Tensor, gk: torch.Tensor, n: int
                      ) -> torch.Tensor:
    """1-D dealiased product via 3/2-rule padding (reference
    rsw/sw1d.m:30-33 KMAXBIG = 3*(KMAX+1)/2-1 zero-padding)."""
    m = 3 * n // 2
    nk = n // 2 + 1
    mk = m // 2 + 1
    fb = torch.cat([fk, fk.new_zeros(mk - nk)])
    gb = torch.cat([gk, gk.new_zeros(mk - nk)])
    fg = torch.fft.irfft(fb, n=m) * m
    gg = torch.fft.irfft(gb, n=m) * m
    pk = torch.fft.rfft(fg * gg) / m
    return pk[:nk]
