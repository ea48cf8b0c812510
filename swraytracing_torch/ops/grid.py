"""Spectral grid descriptor for doubly periodic 2-D domains.

Counterpart of swraytracing_tpu/ops/grid.py. Spectra live on the
``rfft2`` half-plane, shape (nx, ny//2 + 1), with a mask that zeroes the
Nyquist modes so the retained mode set matches the MATLAB reference
(|kx| <= kmax, 0 <= ky <= kmax with kmax = nx/2 - 1;
qgsw_raytrace.m:13-20).

The descriptor itself is host-side numpy metadata (float64). Device code
asks for ``grid.tensors(device, dtype)``, a cached view of the wavenumber
arrays as tensors, so the arrays cross to the device once per
(device, dtype) and not once per call.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["SpectralGrid", "GridTensors", "complex_dtype", "resolve_device",
           "host_array_tensor", "as_tensor"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point creates its tensors on. None means the
    CUDA device, and raises when there is none: the CPU is used only when
    the caller names it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def as_tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    """`a` (a numpy array, or a tensor on any device) as a tensor of
    `dtype` on `device`: what the entry points that take host arrays do
    with them. A tensor that already is one comes back as it is."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


# Device copies of small host arrays, by content (host_array_tensor).
_HOST_ARRAYS: dict = {}
_HOST_ARRAYS_MAX = 256


def host_array_tensor(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A device tensor holding the small host array `values` in `dtype`,
    copied to `device` once per distinct content and reused after: an
    ensemble's per-member step lengths and live masks change only at a
    release, a freeze or a resume, so a step that asks again for the same
    values makes no host-to-device copy (and no synchronisation). The
    tensor is shared: never modify it in place."""
    arr = np.ascontiguousarray(values)
    key = (arr.dtype.str, arr.shape, arr.tobytes(), dtype,
           torch.device(device))
    hit = _HOST_ARRAYS.get(key)
    if hit is None:
        if len(_HOST_ARRAYS) >= _HOST_ARRAYS_MAX:
            _HOST_ARRAYS.pop(next(iter(_HOST_ARRAYS)))  # the oldest
        hit = torch.as_tensor(arr, dtype=dtype, device=key[-1])
        _HOST_ARRAYS[key] = hit
    return hit


def complex_dtype(dtype: torch.dtype) -> torch.dtype:
    """The complex dtype whose parts have the real dtype `dtype`."""
    return torch.complex128 if dtype == torch.float64 else torch.complex64


class GridTensors(NamedTuple):
    """Device view of a SpectralGrid's spectral arrays."""

    kx: torch.Tensor            # (nx, 1) real
    ky: torch.Tensor            # (1, nky) real
    K2: torch.Tensor            # (nx, nky) real
    nyquist_mask: torch.Tensor  # (nx, nky) real
    ikx: torch.Tensor           # (nx, 1) complex, 1j * kx
    iky: torch.Tensor           # (1, nky) complex, 1j * ky


@dataclasses.dataclass(frozen=True)
class SpectralGrid:
    """Static description of a periodic rectangular grid.

    Attributes:
      nx, ny: number of grid points in x (first axis) and y (second axis).
      Lx, Ly: domain lengths. The reference uses L = 2*pi for the RSW/QG
        solvers (rsw/swk.m:85) and L = 20 for the two-layer run
        (qg2layersw_raytrace.m:13).
    """

    nx: int
    ny: int
    Lx: float
    Ly: float

    # -- constructors ------------------------------------------------------

    @staticmethod
    def square(nx: int, L: float = 2.0 * np.pi) -> "SpectralGrid":
        return SpectralGrid(nx=nx, ny=nx, Lx=float(L), Ly=float(L))

    # -- grid-space coordinates -------------------------------------------

    @property
    def dx(self) -> float:
        return self.Lx / self.nx

    @property
    def dy(self) -> float:
        return self.Ly / self.ny

    @cached_property
    def x(self) -> np.ndarray:
        """Periodic sample points in [0, Lx); index 0 sits at x = 0,
        matching the FFT convention and the interpolation's index map
        (index = x/dx mod nx, interpolate.m:21)."""
        return self.dx * np.arange(self.nx)

    @cached_property
    def y(self) -> np.ndarray:
        return self.dy * np.arange(self.ny)

    def wrap_centered(self, pos, axis: str = "x"):
        """Map positions into [-L/2, L/2) (mod L), the reference's output
        convention mod(x + L/2, L) - L/2 (qgsw_raytrace.m:160)."""
        L = self.Lx if axis == "x" else self.Ly
        return np.mod(np.asarray(pos) + L / 2, L) - L / 2

    def meshgrid(self):
        """(X, Y) with indexing='ij' (first axis = x), as the reference's
        ndgrid (qg2layersw_raytrace.m:16)."""
        return np.meshgrid(self.x, self.y, indexing="ij")

    # -- spectral-space layout (rfft2) -------------------------------------

    @property
    def nky(self) -> int:
        """Number of retained ky modes in the rfft2 layout."""
        return self.ny // 2 + 1

    @property
    def kmax(self) -> int:
        """Largest retained integer wavenumber, kmax = nx/2 - 1
        (qgsw_raytrace.m:18)."""
        return self.nx // 2 - 1

    @cached_property
    def kx(self) -> np.ndarray:
        """Physical x-wavenumbers in FFT order, shape (nx, 1)."""
        k = np.fft.fftfreq(self.nx, d=1.0 / self.nx)
        return (2.0 * np.pi / self.Lx) * k[:, None]

    @cached_property
    def ky(self) -> np.ndarray:
        """Physical y-wavenumbers (non-negative half), shape (1, nky)."""
        k = np.arange(self.nky)
        return (2.0 * np.pi / self.Ly) * k[None, :]

    @cached_property
    def K2(self) -> np.ndarray:
        """|k|^2 on the rfft2 half-plane, shape (nx, nky)."""
        return self.kx**2 + self.ky**2

    @cached_property
    def K(self) -> np.ndarray:
        return np.sqrt(self.K2)

    @cached_property
    def nyquist_mask(self) -> np.ndarray:
        """1.0 on modes the reference retains, 0.0 on the Nyquist row/col.

        The reference's half-plane layout has no slot for the Nyquist
        modes (fulspec.m zero-pads them); applying this mask after every
        forward transform reproduces that truncation.
        """
        m = np.ones((self.nx, self.nky))
        m[self.nx // 2, :] = 0.0
        m[:, self.nky - 1] = 0.0 if self.ny % 2 == 0 else 1.0
        return m

    def dealias_mask(self, circular: bool = True) -> np.ndarray:
        """Orszag 2/3-rule mask.

        circular=True matches the reference's radial cutoff
        kcut = sqrt(8/9) * (kmax + 1) (rsw/swk.m:92-95); False gives the
        standard per-axis 2/3 rule.
        """
        ikx = np.fft.fftfreq(self.nx, d=1.0 / self.nx)[:, None]
        iky = np.arange(self.nky)[None, :]
        if circular:
            kcut = np.sqrt(8.0 / 9.0) * (self.kmax + 1)
            m = (np.sqrt(ikx**2 + iky**2) <= kcut).astype(np.float64)
        else:
            cx = (2.0 / 3.0) * (self.nx // 2)
            cy = (2.0 / 3.0) * (self.ny // 2)
            m = ((np.abs(ikx) <= cx) & (iky <= cy)).astype(np.float64)
        return m * self.nyquist_mask

    # -- device view ---------------------------------------------------------

    @cached_property
    def _tensor_cache(self) -> dict:
        return {}

    def tensors(self, device, dtype: torch.dtype) -> GridTensors:
        """kx, ky, K2, nyquist_mask (and 1j*kx, 1j*ky) as tensors of the
        real dtype `dtype` on `device`, built once per (device, dtype)."""
        key = (torch.device(device), dtype)
        hit = self._tensor_cache.get(key)
        if hit is None:
            cd = complex_dtype(dtype)

            def real(a):
                return torch.as_tensor(a, dtype=dtype, device=key[0])

            def imag(a):
                return torch.as_tensor(1j * a, dtype=cd, device=key[0])

            hit = GridTensors(kx=real(self.kx), ky=real(self.ky),
                              K2=real(self.K2),
                              nyquist_mask=real(self.nyquist_mask),
                              ikx=imag(self.kx), iky=imag(self.ky))
            self._tensor_cache[key] = hit
        return hit

    # -- misc ---------------------------------------------------------------

    @property
    def spectral_shape(self) -> tuple:
        return (self.nx, self.nky)

    @property
    def shape(self) -> tuple:
        return (self.nx, self.ny)
