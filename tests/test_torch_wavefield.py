"""swraytracing_torch.analysis.wavefield against the JAX package (CPU,
float64): the assertions of the JAX package's
tests/test_drivers.py::test_wavefield_reconstruction through the port,
and the port's fields equal to JAX's."""

import numpy as np
import torch

from swraytracing_tpu.analysis.wavefield import (
    reconstruct_wavefield as j_wave)
from swraytracing_tpu.models.dispersion import Dispersion as JDispersion
from swraytracing_tpu.ops.grid import SpectralGrid as JGrid
from swraytracing_torch.analysis.wavefield import reconstruct_wavefield
from swraytracing_torch.models.dispersion import Dispersion
from swraytracing_torch.ops.grid import SpectralGrid

from torch_parity import to_jax, to_torch, to_numpy, assert_close

GRID, JG = SpectralGrid.square(64), JGrid.square(64)
DISP, JD = Dispersion(f=3.0, Cg=1.0), JDispersion(f=3.0, Cg=1.0)


def test_wavefield_reconstruction():
    """A single packet is locally a plane wave of its wavenumber under a
    Gaussian envelope peaking sqrt(a/omega) at the packet; superposition
    is linear; the field is periodic in the domain."""
    L = GRID.Lx
    x = to_torch(np.array([[L / 2], [L / 2]]))
    k = to_torch(np.array([[8.0], [0.0]]))
    a = to_torch(np.array([2.0]))
    eta = to_numpy(reconstruct_wavefield(x, k, GRID, DISP, action=a,
                                         width=1.0))
    om = float(np.sqrt(9.0 + 64.0))
    i0 = 32  # grid index of L/2
    assert abs(eta[i0, i0] - np.sqrt(2.0 / om)) < 1e-6
    row = eta[:, i0]
    lam_cells = int(round(2 * np.pi / 8.0 / GRID.dx))
    j = i0 + lam_cells
    assert row[j] == row[j - 3:j + 4].max() and row[j] > 0
    assert abs(eta[0, 0]) < 1e-3 * eta[i0, i0]
    x2 = to_torch(np.array([[L / 4, 3 * L / 4], [L / 2, L / 2]]))
    k2 = to_torch(np.array([[8.0, 8.0], [0.0, 0.0]]))
    both = to_numpy(reconstruct_wavefield(x2, k2, GRID, DISP))
    one = to_numpy(reconstruct_wavefield(x2[:, :1], k2[:, :1], GRID, DISP))
    two = to_numpy(reconstruct_wavefield(x2[:, 1:], k2[:, 1:], GRID, DISP))
    np.testing.assert_allclose(both, one + two, atol=1e-12)


def test_wavefield_matches_jax():
    """A packet count that is no multiple of the port's chunk, with
    action, time, width and a geostrophic surface: equal to JAX's packet
    by packet scan to atol 1e-12 (O(1) values summed in another order)."""
    rng = np.random.default_rng(4)
    n = 11
    x = rng.uniform(-1.0, 7.0, (2, n))
    k = rng.uniform(-9.0, 9.0, (2, n))
    a = rng.uniform(0.0, 3.0, n)
    eta_g = rng.standard_normal(GRID.shape)
    kw = dict(t=0.37, width=0.5)
    got = reconstruct_wavefield(to_torch(x), to_torch(k), GRID, DISP,
                                action=to_torch(a), eta_g=to_torch(eta_g),
                                **kw)
    want = j_wave(to_jax(x), to_jax(k), JG, JD, action=to_jax(a),
                  eta_g=to_jax(eta_g), **kw)
    assert got.shape == GRID.shape and got.dtype == torch.float64
    assert_close(got, want, atol=1e-12)
    got = reconstruct_wavefield(to_torch(x), to_torch(k), GRID, DISP)
    assert_close(got, j_wave(to_jax(x), to_jax(k), JG, JD), atol=1e-12)
