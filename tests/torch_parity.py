"""Shared helpers of the tests/test_torch_*.py files: the same numpy
inputs go to the JAX package (CPU, x64; tests/conftest.py sets both) and
to swraytracing_torch (CPU, float64), and the outputs are compared as
numpy arrays."""

import numpy as np
import jax.numpy as jnp
import torch

# tier-1 runs several xdist workers on few cores: one thread per worker
torch.set_num_threads(1)

NX = 32
L = 2.0 * np.pi


def to_jax(a):
    return jnp.asarray(np.asarray(a))


def to_torch(a):
    """numpy -> CPU tensor of the same precision (float64/complex128
    inputs stay so)."""
    return torch.from_numpy(np.array(a))  # a writable copy


def to_numpy(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def assert_close(got_torch, want_jax, rtol=0.0, atol=0.0, err_msg=""):
    got, want = to_numpy(got_torch), to_numpy(want_jax)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=err_msg)


def assert_equal(got_torch, want_jax, err_msg=""):
    got, want = to_numpy(got_torch), to_numpy(want_jax)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    np.testing.assert_array_equal(got, want, err_msg=err_msg)


def smooth_fields(rng, n, nx=NX):
    """n smooth random (nx, nx) fields, so interpolation is
    well-conditioned."""
    def smooth():
        f = rng.standard_normal((nx, nx))
        fk = np.fft.rfft2(f)
        kx = np.fft.fftfreq(nx)[:, None]
        ky = np.fft.rfftfreq(nx)[None, :]
        fk *= np.exp(-((kx * nx / 6) ** 2 + (ky * nx / 6) ** 2))
        return np.fft.irfft2(fk, s=(nx, nx))

    return np.stack([smooth() for _ in range(n)])


def random_spectrum(rng, grid, batch=()):
    """Spectrum of a random real field (Hermitian by construction,
    Nyquist modes masked), as numpy complex128 in the rfft2 layout."""
    f = rng.standard_normal(tuple(batch) + (grid.nx, grid.ny))
    return np.fft.rfft2(f) / (grid.nx * grid.ny) * grid.nyquist_mask


def jax_carry_tree(c):
    """A JAX CoupledCarry as the plain dict of numpy arrays that
    swraytracing_torch.convert.carry_from_numpy takes."""
    fs = c.flow_state
    return {
        "flow_state": {"qk": np.asarray(fs.qk), "rhs_m1": np.asarray(fs.rhs_m1),
                       "rhs_m2": np.asarray(fs.rhs_m2), "t": np.asarray(fs.t),
                       "step": np.asarray(fs.step)},
        "packet_x": np.asarray(c.packet_x),
        "packet_k": np.asarray(c.packet_k),
        "prev_fields": np.asarray(c.prev_fields),
        "prev_win": None if c.prev_win is None else np.asarray(c.prev_win),
        "overflow": None if c.overflow is None else np.asarray(c.overflow),
    }
