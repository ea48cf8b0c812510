"""swraytracing_torch.models.rays and dispersion against the JAX package
on the same numpy inputs (CPU, float64)."""

import numpy as np
import pytest
import torch

from swraytracing_tpu.ops.grid import SpectralGrid as JGrid
from swraytracing_tpu.models import rays as jrays
from swraytracing_tpu.models.dispersion import Dispersion as JDispersion
from swraytracing_tpu.models.fields import GriddedFlow as JFlow
from swraytracing_torch.ops.grid import SpectralGrid as TGrid
from swraytracing_torch.models import rays as trays
from swraytracing_torch.models.dispersion import Dispersion as TDispersion
from swraytracing_torch.models.fields import GriddedFlow as TFlow

from torch_parity import (NX, L, to_jax, to_torch, to_numpy, assert_close,
                          smooth_fields)

JD, TD = JDispersion(f=3.0, Cg=1.5), TDispersion(f=3.0, Cg=1.5)
DT = 0.01

# One step is a handful of interpolations (36 products each) and O(10)
# multiply-adds on O(1..10) values.
ATOL = 1e-12


def _state(n=100, seed=0):
    rng = np.random.default_rng(seed)
    F = 0.5 * smooth_fields(rng, 6)
    x = rng.uniform(-L, 2 * L, (2, n))
    k = rng.normal(0, 3.0, (2, n))
    return (JFlow(fields=to_jax(F), grid=JGrid.square(NX)),
            TFlow(fields=to_torch(F), grid=TGrid.square(NX)), x, k)


def test_ray_rhs():
    jflow, tflow, x, k = _state()
    jdx, jdk = jrays.ray_rhs(to_jax(x), to_jax(k), 0.0, JD, jflow)
    tdx, tdk = trays.ray_rhs(to_torch(x), to_torch(k), 0.0, TD, tflow)
    assert tdx.shape == (2, 100)
    assert_close(tdx, jdx, atol=ATOL)
    assert_close(tdk, jdk, atol=ATOL)


@pytest.mark.parametrize("name", ["symplectic_step", "yoshida4_step",
                                  "rk4_step", "rk23_step"])
def test_one_step_of_each_stepper(name):
    jflow, tflow, x, k = _state(seed=1)
    jx, jk = getattr(jrays, name)(to_jax(x), to_jax(k), DT, JD, jflow)
    tx, tk = getattr(trays, name)(to_torch(x), to_torch(k), DT, TD, tflow)
    assert_close(tx, jx, atol=ATOL)
    assert_close(tk, jk, atol=ATOL)
    assert float((tx - to_torch(x)).abs().max()) > 1e-3   # a real step


def test_symplectic_step_kicks_at_the_pre_kick_position():
    """phi2 uses the fields at the position after the half drift, and the
    wavevector before the kick, for both components."""
    _, tflow, x, k = _state(n=10, seed=2)
    xt, kt = to_torch(x), to_torch(k)
    xh = xt + 0.5 * DT * TD.group_velocity(kt)
    ev = tflow.at(xh[0], xh[1])
    k1 = kt - DT * ev.refraction(kt)
    x1 = xh + DT * ev.uv + 0.5 * DT * TD.group_velocity(k1)
    got = trays.symplectic_step(xt, kt, DT, TD, tflow)
    assert_close(got[0], to_numpy(x1), atol=1e-15)
    assert_close(got[1], to_numpy(k1), atol=1e-15)


def test_integrate_rays_frames():
    jflow, tflow, x, k = _state(n=20, seed=3)
    jx, jk, jt = jrays.integrate_rays(
        to_jax(x), to_jax(k), DT, 7,
        lambda a, b, t: jrays.rk23_step(a, b, DT, JD, jflow), save_every=3,
        t0=0.5)
    seen = []

    def step(a, b, t):
        seen.append(t)
        return trays.rk23_step(a, b, DT, TD, tflow)

    tx, tk, tt = trays.integrate_rays(to_torch(x), to_torch(k), DT, 7, step,
                                      save_every=3, t0=0.5)
    assert tx.shape == (2, 2, 20) and tt.dtype == torch.float64
    assert_close(tx, jx, atol=1e-11)
    assert_close(tk, jk, atol=1e-11)
    assert_close(tt, jt, rtol=1e-14)
    np.testing.assert_allclose(seen, 0.5 + DT * np.arange(6), rtol=1e-14)
    none = trays.integrate_rays(to_torch(x), to_torch(k), DT, 2, step,
                                save_every=3)
    assert none[0].shape == (0, 2, 20) and none[2].shape == (0,)


def test_absolute_frequency():
    k = np.random.default_rng(6).normal(0, 3.0, (2, 50))
    u = np.random.default_rng(7).normal(0, 0.4, (2, 50))
    assert_close(TD.absolute_frequency(to_torch(k), to_torch(u)),
                 JD.absolute_frequency(to_jax(k), to_jax(u)), rtol=1e-15)


def test_rk4_step_gradients():
    """Autograd through one RK4 step (four stencil gathers) against
    jax.grad."""
    import jax
    import jax.numpy as jnp
    jflow, tflow, x, k = _state(n=8, seed=4)

    def loss_j(x_, k_):
        xn, kn = jrays.rk4_step(x_, k_, DT, JD, jflow)
        return jnp.sum(jnp.sin(xn)) + jnp.sum(kn ** 2)

    want = jax.grad(loss_j, argnums=(0, 1))(to_jax(x), to_jax(k))
    xt = to_torch(x).requires_grad_(True)
    kt = to_torch(k).requires_grad_(True)
    xn, kn = trays.rk4_step(xt, kt, DT, TD, tflow)
    (torch.sin(xn).sum() + (kn ** 2).sum()).backward()
    assert_close(xt.grad, want[0], rtol=1e-10, atol=1e-11)
    assert_close(kt.grad, want[1], rtol=1e-10, atol=1e-11)
