"""swraytracing_torch.models.sw1d against the JAX package on the same numpy
inputs (CPU, float64), with the JAX tests' sizes and parameters: sw1 with
particles, sw1_forced, sw1rk3nu, ybj1d (complex128 and complex64) and
advect1d; and what a float32 run keeps in float32."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from swraytracing_tpu.models import sw1d as js
from swraytracing_tpu.models import examples_1d as jex1
from swraytracing_torch.models import sw1d as ts

from torch_parity import assert_close, assert_equal

F64 = dict(device="cpu", dtype=torch.float64)
# frames and energies of float64 runs of 100-500 steps on 64-128 points
ATOL_FRAMES = 1e-10
RTOL_ENERGY = 1e-10


def _check(got, want, rtol_energy=RTOL_ENERGY):
    U, t, ke, pe = got[:4]
    JU, Jt, Jke, Jpe = want[:4]
    assert_close(U, JU, atol=ATOL_FRAMES)
    assert_close(t, Jt, rtol=1e-13)
    assert_close(ke, Jke, rtol=rtol_energy)
    assert_close(pe, Jpe, rtol=rtol_energy)


@pytest.mark.parametrize("a,k0", [(0.05, 6), (0.2, 2)])
def test_sw1_with_particles(a, k0):
    _, U0 = jex1.plane_wave_1d(128, 1.0, 1.0, a, k0)
    p = ts.SW1Params(f=1.0, Cg=1.0)
    xp0 = np.linspace(-3.0, 3.0, 16)
    want = js.sw1(jnp.asarray(U0), js.SW1Params(*p), 200, 50,
                  Xp0=jnp.asarray(xp0))
    got = ts.sw1(U0, p, 200, 50, Xp0=xp0, **F64)
    _check(got, want)
    assert got[0].shape == (4, 128, 3) and got[4].shape == (4, 16)
    assert_close(got[4], want[4], atol=ATOL_FRAMES)
    assert ts.sw1(U0, p, 10, 10, **F64)[4] is None


def test_sw1_forced():
    n = 64
    x = np.linspace(0, 2 * np.pi, n, endpoint=False)
    U0 = np.stack([0.2 * np.cos(2 * x), 0.1 * np.sin(x),
                   0.1 * np.cos(x)], axis=1)
    kw = dict(Ro=0.05, Bu=0.8, V0=0.3, Kv=2, dt=0.002, nsteps=200,
              save_every=50)
    _check(ts.sw1_forced(U0, **kw, **F64),
           js.sw1_forced(jnp.asarray(U0), **kw))


@pytest.mark.parametrize("Ro,nu,S", [(0.0, 1e-6, 2), (0.3, 1e-9, 4)])
def test_sw1rk3nu(Ro, nu, S):
    """Its dt is constant, fixed by the initial condition on the host
    (the reference's quirk), in both packages."""
    _, U0 = jex1.sw1setup_wave(n=5, etahat=0.05, Bu=1.0, k=4)
    kw = dict(Ro=Ro, Bu=1.0, nu=nu, nsteps=200, save_every=50, S=S)
    got = ts.sw1rk3nu(U0, **kw, **F64)
    want = js.sw1rk3nu(jnp.asarray(U0), **kw)
    _check(got, want)
    assert_equal(got[1], want[1])


@pytest.mark.parametrize("complex128", [True, False])
def test_ybj1d(complex128):
    """complex128 input stays complex128, as in the JAX package; complex64
    input runs in complex64 (compared at float32's tolerance)."""
    n = 64
    x = np.linspace(0, 2 * np.pi, n, endpoint=False)
    A0 = np.exp(1j * x) + 0.3 * np.exp(2j * x)
    if not complex128:
        A0 = A0.astype(np.complex64)
    kw = dict(Bu=0.5, V0=0.4, Kv=2, dt=1e-3, nsteps=400, save_every=100)
    A, t = ts.ybj1d(A0, **kw, device="cpu")
    JA, Jt = js.ybj1d(jnp.asarray(A0), **kw)
    assert A.dtype == (torch.complex128 if complex128 else torch.complex64)
    assert_close(A, JA, atol=ATOL_FRAMES if complex128 else 2e-5)
    assert_close(t, Jt, rtol=1e-13)
    # wave action is conserved (the operator is i*(Hermitian))
    act = (A.abs() ** 2).sum(dim=1)
    np.testing.assert_allclose(act.numpy(), act[0].item(), rtol=1e-5)
    A64, _ = ts.ybj1d(A0, **kw, device="cpu", dtype=torch.float64)
    assert A64.dtype == torch.complex128


def test_advect1d_parity():
    n = 32
    x = np.arange(n) * 2 * np.pi / n
    u = 0.5 + 0.2 * np.sin(x)
    dx = 2 * np.pi / n
    xp = np.array([0.0, 3.0, -1.3, 2 * np.pi - 1e-14, 9.0])
    got = ts.advect1d(torch.tensor(xp), torch.tensor(u), dx, 0.1)
    want = js.advect1d(jnp.asarray(xp), jnp.asarray(u), dx, 0.1)
    assert_close(got, want, atol=1e-15)
    const = ts.advect1d(torch.tensor(xp), torch.full((n,), 0.5,
                                                     dtype=torch.float64),
                        torch.tensor(dx), 0.1)
    np.testing.assert_allclose(const.numpy(), xp + 0.05, rtol=1e-12)


def test_float32_runs_stay_float32():
    _, U0 = jex1.plane_wave_1d(64, 1.0, 1.0, 0.05, 3)
    f32 = dict(device="cpu", dtype=torch.float32)
    U, t, ke, pe, xp = ts.sw1(U0, ts.SW1Params(f=1.0, Cg=1.0), 4, 2,
                              Xp0=np.zeros(3), **f32)
    assert U.dtype == ke.dtype == pe.dtype == xp.dtype == torch.float32
    assert t.dtype == torch.float64
    for run in (ts.sw1_forced(U0, 0.1, 1.0, 0.2, 1, 1e-3, 4, 2, **f32),
                ts.sw1rk3nu(U0, 0.1, 1.0, 1e-6, 4, 2, **f32)):
        assert run[0].dtype == run[2].dtype == torch.float32
        assert run[1].dtype == torch.float64
    A, _ = ts.ybj1d(np.exp(1j * np.arange(64) * 0.1), 0.5, 0.4, 2, 1e-3, 4,
                    2, **f32)
    assert A.dtype == torch.complex64
