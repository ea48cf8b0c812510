"""swraytracing_torch.ops.spectral / ops.grid against the JAX package on
the same numpy inputs (CPU, float64)."""

import numpy as np
import pytest
import torch

from swraytracing_tpu.ops.grid import SpectralGrid as JGrid
from swraytracing_tpu.ops import spectral as jsp
from swraytracing_torch.ops.grid import SpectralGrid as TGrid
from swraytracing_torch.ops import spectral as tsp

from torch_parity import (to_jax, to_torch, to_numpy, assert_close,
                          assert_equal, random_spectrum)

# Both sides run a float64 FFT (pocketfft under jnp.fft and torch.fft) and
# the same few multiplies; they differ only by the transforms' summation
# order, a few ulp of values that are O(1).
ATOL = 1e-13


def _grids(nx=32, ny=None, Lx=2 * np.pi, Ly=None):
    ny = nx if ny is None else ny
    Ly = Lx if Ly is None else Ly
    return JGrid(nx, ny, Lx, Ly), TGrid(nx, ny, Lx, Ly)


@pytest.mark.parametrize("nx,ny,Lx,Ly", [(32, 32, 2 * np.pi, 2 * np.pi),
                                         (16, 24, 20.0, 13.0)])
def test_grid_arrays_equal(nx, ny, Lx, Ly):
    jg, tg = _grids(nx, ny, Lx, Ly)
    for name in ("kx", "ky", "K2", "K", "nyquist_mask", "x", "y"):
        assert_equal(getattr(tg, name), getattr(jg, name), name)
    for circ in (True, False):
        assert_equal(tg.dealias_mask(circ), jg.dealias_mask(circ))
    assert (tg.dx, tg.dy, tg.nky, tg.kmax) == (jg.dx, jg.dy, jg.nky, jg.kmax)
    gt = tg.tensors("cpu", torch.float64)
    assert gt is tg.tensors("cpu", torch.float64)  # cached view
    assert_equal(gt.K2, jg.K2)
    assert_equal(gt.ikx, 1j * jg.kx)
    assert tg.tensors("cpu", torch.float32).ikx.dtype == torch.complex64


def test_to_spectral_to_grid_round_trip_and_parity():
    jg, tg = _grids(16, 24, 20.0, 13.0)
    rng = np.random.default_rng(0)
    f = rng.standard_normal((3, 16, 24))
    fk_t = tsp.to_spectral(to_torch(f), tg)
    fk_j = jsp.to_spectral(to_jax(f), jg, backend="fft")
    assert_close(fk_t, fk_j, atol=ATOL)
    back_t = tsp.to_grid(fk_t, tg)
    assert_close(back_t, jsp.to_grid(fk_j, jg, backend="fft"), atol=ATOL)
    # round trip: exact up to the masked Nyquist content of f
    fk_full = np.fft.rfft2(f) / (16 * 24)
    nyq = np.fft.irfft2(fk_full * (1 - tg.nyquist_mask), s=(16, 24)) * 16 * 24
    np.testing.assert_allclose(to_numpy(back_t), f - nyq, atol=1e-12)


def test_ddx_ddy_parity():
    jg, tg = _grids(32, Lx=20.0)
    fk = random_spectrum(np.random.default_rng(1), tg, batch=(2,))
    assert_close(tsp.ddx(to_torch(fk), tg), jsp.ddx(to_jax(fk), jg),
                 atol=ATOL)
    assert_close(tsp.ddy(to_torch(fk), tg), jsp.ddy(to_jax(fk), jg),
                 atol=ATOL)


@pytest.mark.parametrize("ny", [32, 31])
def test_enforce_hermitian_parity(ny):
    jg, tg = _grids(32, ny)
    rng = np.random.default_rng(2)
    fk = (rng.standard_normal(tg.spectral_shape)
          + 1j * rng.standard_normal(tg.spectral_shape))
    src = to_torch(fk)
    got = tsp.enforce_hermitian(src, tg)
    assert_close(got, jsp.enforce_hermitian(to_jax(fk), jg), atol=1e-15)
    assert_equal(src, fk)  # the input is left untouched


@pytest.mark.parametrize("dealias", [False, True])
def test_dealiased_jacobian_parity(dealias):
    jg, tg = _grids(32, Lx=20.0)
    rng = np.random.default_rng(3)
    ak = random_spectrum(rng, tg)
    bk = random_spectrum(rng, tg)
    got = tsp.dealiased_jacobian(to_torch(ak), to_torch(bk), tg,
                                 dealias=dealias)
    want = jsp.dealiased_jacobian(to_jax(ak), to_jax(bk), jg,
                                  dealias=dealias)
    assert_close(got, want, atol=ATOL)


def test_padded_product_parity_and_batch():
    jg, tg = _grids(16, 24, 20.0, 13.0)
    rng = np.random.default_rng(4)
    fk = random_spectrum(rng, tg, batch=(2,))
    gk = random_spectrum(rng, tg, batch=(2,))
    got = tsp.padded_product(to_torch(fk), to_torch(gk), tg)
    for b in range(2):  # the JAX function takes one spectrum at a time
        want = jsp.padded_product(to_jax(fk[b]), to_jax(gk[b]), jg)
        assert_close(got[b], want, atol=ATOL)


def test_exp_filter_equal():
    jg, tg = _grids(32, 48, 20.0, 20.0)
    assert_equal(tsp.exp_filter(tg), jsp.exp_filter(jg))
    assert_equal(tsp.exp_filter(tg, cutoff=2.0, decay_width=0.5),
                 jsp.exp_filter(jg, cutoff=2.0, decay_width=0.5))


def test_float32_stays_float32():
    _, tg = _grids(16)
    f = torch.as_tensor(np.random.default_rng(5).standard_normal((16, 16)),
                        dtype=torch.float32)
    fk = tsp.to_spectral(f, tg)
    assert fk.dtype == torch.complex64
    assert tsp.ddx(fk, tg).dtype == torch.complex64
    assert tsp.to_grid(fk, tg).dtype == torch.float32


@pytest.mark.parametrize("nx", [32, 24])
def test_refspec_layout_parity(nx):
    """rfft2 <-> the reference's fftshifted half-plane: numpy in, the JAX
    package's numpy out exactly."""
    jg, tg = _grids(nx)
    fk = random_spectrum(np.random.default_rng(6), tg)
    ref = tsp.rfft2_to_refspec(fk, tg)
    assert isinstance(ref, np.ndarray) and ref.dtype == np.complex128
    assert_equal(ref, jsp.rfft2_to_refspec(fk, jg))
    assert ref.shape == (2 * tg.kmax + 1, tg.kmax + 1)
    back = tsp.refspec_to_rfft2(ref, tg)
    assert_equal(back, jsp.refspec_to_rfft2(ref, jg))
    np.testing.assert_array_equal(back, fk * (np.arange(tg.nky) <= tg.kmax)
                                  * (np.abs(np.fft.fftfreq(nx, 1 / nx))
                                     <= tg.kmax)[:, None])


def test_1d_transforms_parity():
    n = 64
    rng = np.random.default_rng(7)
    f = rng.standard_normal((n,))
    g = rng.standard_normal((n,))
    fk_t = tsp.to_spectral_1d(to_torch(f), n)
    fk_j = jsp.to_spectral_1d(to_jax(f), n)
    assert_close(fk_t, fk_j, atol=ATOL)
    assert_close(tsp.to_grid_1d(fk_t, n), jsp.to_grid_1d(fk_j, n), atol=ATOL)
    gk_t = tsp.to_spectral_1d(to_torch(g), n)
    gk_j = jsp.to_spectral_1d(to_jax(g), n)
    got = tsp.padded_product_1d(fk_t, gk_t, n)
    assert_close(got, jsp.padded_product_1d(fk_j, gk_j, n), atol=ATOL)
    # the reference's dealiasing: cos 5x * cos 7x on 64 points, exactly
    x = 2 * np.pi * np.arange(n) / n
    pk = tsp.padded_product_1d(tsp.to_spectral_1d(to_torch(np.cos(5 * x)),
                                                  n),
                               tsp.to_spectral_1d(to_torch(np.cos(7 * x)),
                                                  n), n)
    true = tsp.to_spectral_1d(
        to_torch(0.5 * (np.cos(12 * x) + np.cos(2 * x))), n)
    np.testing.assert_allclose(to_numpy(pk), to_numpy(true), atol=1e-15)
    f32 = tsp.padded_product_1d(fk_t.to(torch.complex64),
                                gk_t.to(torch.complex64), n)
    assert f32.dtype == torch.complex64
