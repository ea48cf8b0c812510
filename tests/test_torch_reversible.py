"""swraytracing_torch.models.reversible (the O(1)-memory gradient of the
symplectic ray loop) against plain autograd through the loop, finite
differences and the JAX package's integrator (CPU, float64), and the
gradient budgets of the JAX package's tests/test_rays.py and
tests/test_f32_budget.py through the port."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from swraytracing_tpu.models import analytic as jan
from swraytracing_tpu.models.dispersion import Dispersion as JDispersion
from swraytracing_tpu.models import reversible as jrev
from swraytracing_torch.models import analytic, rays
from swraytracing_torch.models.dispersion import Dispersion
from swraytracing_torch.models.fields import flow_from_psi_grid
from swraytracing_torch.models.reversible import (make_reversible_integrator,
                                                  inverse_symplectic_step)
from swraytracing_torch.ops.grid import SpectralGrid

from torch_parity import to_jax, to_torch, assert_close

DISP = Dispersion(f=3.0, Cg=1.0)
F64 = dict(device="cpu", dtype=torch.float64)


def _ics(n=8, ki=8.0, seed=0):
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(n) / n
    x0 = rng.uniform(0, 2 * np.pi, (2, n))
    k0 = ki * np.stack([np.cos(ang), np.sin(ang)], 0)
    return to_torch(x0), to_torch(k0)


def _final(x0, k0, flow, dt, n):
    step = lambda x, k, t: rays.symplectic_step(x, k, dt, DISP, flow)
    xs, ks, _ = rays.integrate_rays(x0, k0, dt, n, step, save_every=n)
    return xs[-1], ks[-1]


def test_inverse_step_reconstructs():
    """inverse o forward = identity to fixed-point tolerance (atol 1e-12)."""
    flow = analytic.childress_soward(U0=0.2, **F64)
    x0, k0 = _ics()
    dt = 0.01
    x1, k1 = rays.symplectic_step(x0, k0, dt, DISP, flow)
    xr, kr = inverse_symplectic_step(x1, k1, dt, DISP, flow)
    assert_close(xr, x0, atol=1e-12)
    assert_close(kr, k0, atol=1e-12)


def test_reversible_forward_matches_scan():
    flow = analytic.childress_soward(U0=0.15, **F64)
    x0, k0 = _ics()
    dt, n = 0.01, 200
    xN, kN = make_reversible_integrator(DISP, dt, n)(x0, k0, flow)
    xs, ks = _final(x0, k0, flow, dt, n)
    assert_close(xN, xs, rtol=1e-12)
    assert_close(kN, ks, rtol=1e-12)


def test_reversible_grad_matches_autodiff_analytic():
    """O(1)-memory backward == plain autograd through the loop, for both
    packet ICs and the analytic flow parameter (rtol 1e-8 for U0, 1e-7
    for k0, as the JAX package's test)."""
    x0, k0 = _ics(4)
    dt, n = 0.01, 100

    def grads(reversible):
        U0 = torch.tensor(0.12, dtype=torch.float64, requires_grad=True)
        k = k0.clone().requires_grad_(True)
        flow = analytic.childress_soward(U0=U0, **F64)
        if reversible:
            xN, kN = make_reversible_integrator(DISP, dt, n)(x0, k, flow)
        else:
            xN, kN = _final(x0, k, flow, dt, n)
        loss = (kN ** 2).mean() + (torch.sin(xN) ** 2).mean()
        return torch.autograd.grad(loss, (U0, k))

    gU_r, gk_r = grads(True)
    gU_s, gk_s = grads(False)
    np.testing.assert_allclose(float(gU_r), float(gU_s), rtol=1e-8)
    assert_close(gk_r, gk_s.numpy(), rtol=1e-7, atol=1e-12)


def test_reversible_grad_wrt_gridded_flow_spectrum():
    """Gradient w.r.t. the gridded flow's streamfunction grid (through the
    linear spectral construction of its fields) at O(1) memory: equal to
    plain autograd (rtol 1e-6, atol 1e-10) and to a central difference
    (rtol 1e-4), as the JAX package's test. The finite-difference
    identity for a real input is FD == <g, d>."""
    grid = SpectralGrid.square(32)
    X, Y = grid.meshgrid()
    psi0 = to_torch(0.1 * (np.sin(X) * np.sin(Y)))
    x0, k0 = _ics(4)
    dt, n = 0.01, 60

    def loss(psi, reversible):
        flow = flow_from_psi_grid(psi, grid)
        if reversible:
            _, kN = make_reversible_integrator(DISP, dt, n)(x0, k0, flow)
        else:
            _, kN = _final(x0, k0, flow, dt, n)
        return (kN ** 2).mean()

    def grad(reversible):
        psi = psi0.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(psi, reversible), psi)
        return g

    g_r, g_s = grad(True), grad(False)
    assert_close(g_r, g_s.numpy(), rtol=1e-6, atol=1e-10)
    d = to_torch(np.random.default_rng(3).standard_normal(psi0.shape))
    eps = 1e-6
    with torch.no_grad():
        fd = (loss(psi0 + eps * d, False) - loss(psi0 - eps * d, False)) \
            / (2 * eps)
    np.testing.assert_allclose(float((g_r * d).sum()), float(fd), rtol=1e-4)


def test_long_loop_reconstruction_stability():
    """Reconstruction drift over 2000 steps stays at roundoff level."""
    flow = analytic.childress_soward(U0=0.2, **F64)
    x0, k0 = _ics(8, ki=10.0)
    dt, n = 0.005, 2000
    xN, kN = make_reversible_integrator(DISP, dt, n)(x0, k0, flow)
    xr, kr = xN, kN
    for _ in range(n):
        xr, kr = inverse_symplectic_step(xr, kr, dt, DISP, flow)
    assert float((xr - x0).abs().max()) < 1e-9
    assert float((kr - k0).abs().max()) < 1e-9


def test_reversible_matches_jax_integrator():
    """The port's reversible integrator against the JAX package's
    make_reversible_integrator on the same inputs: final state and the
    gradients w.r.t. U0, a and k0 (rtol 1e-10)."""
    x0, k0 = _ics(6, seed=5)
    dt, n = 0.01, 80

    def jloss(U0, a, k):
        flow = jan.childress_soward(U0=U0, a=a)
        xN, kN = jrev.make_reversible_integrator(
            JDispersion(f=3.0, Cg=1.0), dt, n)(to_jax(x0), k, flow)
        return jnp.mean(kN ** 2) + jnp.mean(jnp.cos(xN)), (xN, kN)

    (jg, (jxN, jkN)) = jax.grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(0.15), jnp.asarray(0.3), to_jax(k0))
    U0 = torch.tensor(0.15, dtype=torch.float64, requires_grad=True)
    a = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    k = k0.clone().requires_grad_(True)
    flow = analytic.childress_soward(U0=U0, a=a, **F64)
    xN, kN = make_reversible_integrator(DISP, dt, n)(x0, k, flow)
    assert_close(xN, jxN, rtol=1e-12, atol=1e-13)
    assert_close(kN, jkN, rtol=1e-12, atol=1e-13)
    loss = (kN ** 2).mean() + torch.cos(xN).mean()
    gU, ga, gk = torch.autograd.grad(loss, (U0, a, k))
    assert_close(gU, jg[0], rtol=1e-10)
    assert_close(ga, jg[1], rtol=1e-10)
    assert_close(gk, jg[2], rtol=1e-10, atol=1e-14)


def _budget_loss(dtype):
    """tests/test_rays.py / test_f32_budget.py's loss: 50 symplectic steps
    through the Childress–Soward flow from 4 packets on a ring."""
    rng = np.random.default_rng(0)
    ang = 2 * np.pi * np.arange(4) / 4
    x0 = torch.as_tensor(rng.uniform(0, 2 * np.pi, (2, 4)), dtype=dtype)
    k0 = torch.as_tensor(8.0 * np.stack([np.cos(ang), np.sin(ang)], 0),
                         dtype=dtype)
    dt = 0.01

    def loss(U0, k):
        flow = analytic.childress_soward(U0=U0, device="cpu", dtype=dtype)
        xN, kN = _final(x0, k, flow, dt, 50)
        return (kN ** 2).mean() + (xN ** 2).mean()

    return loss, k0


def _fd(loss, k0, dk, eps=1e-6):
    with torch.no_grad():
        fdU = (loss(0.1 + eps, k0) - loss(0.1 - eps, k0)) / (2 * eps)
        fdk = (loss(0.1, k0 + eps * dk) - loss(0.1, k0 - eps * dk)) \
            / (2 * eps)
    return float(fdU), float(fdk)


def _grads(loss, k0, dtype):
    U0 = torch.tensor(0.1, dtype=dtype, requires_grad=True)
    k = k0.clone().requires_grad_(True)
    return torch.autograd.grad(loss(U0, k), (U0, k))


def test_gradients_vs_finite_differences():
    """tests/test_rays.py's check through the port: exact float64
    gradients through the symplectic loop w.r.t. the flow parameter U0 and
    the packet ICs against central differences, rtol 1e-5."""
    loss, k0 = _budget_loss(torch.float64)
    gU, gk = _grads(loss, k0, torch.float64)
    dk = torch.as_tensor(np.random.default_rng(2).standard_normal(k0.shape))
    fdU, fdk = _fd(loss, k0, dk)
    np.testing.assert_allclose(float(gU), fdU, rtol=1e-5)
    np.testing.assert_allclose(float((gk * dk).sum()), fdk, rtol=1e-5)


def test_f32_gradient_vs_fd_budget():
    """tests/test_f32_budget.py's budget through the port: float32
    autograd against float64 central differences, rtol 2e-3 over the
    50-step loop (float32 roundoff ~1e-7 a step through the backward sweep
    makes ~1e-4 relative on U0's O(0.1) gradient; 2e-3 leaves the JAX
    package's 20x headroom)."""
    loss32, k032 = _budget_loss(torch.float32)
    gU32, gk32 = _grads(loss32, k032, torch.float32)
    assert gU32.dtype == torch.float32 and gk32.dtype == torch.float32
    loss64, k064 = _budget_loss(torch.float64)
    dk = torch.as_tensor(np.random.default_rng(2).standard_normal(k064.shape))
    fdU, fdk = _fd(loss64, k064, dk)
    np.testing.assert_allclose(float(gU32), fdU, rtol=2e-3)
    np.testing.assert_allclose(float((gk32.double() * dk).sum()), fdk,
                               rtol=2e-3)
