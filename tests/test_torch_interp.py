"""swraytracing_torch.ops.interp (the stencil, windowed and bicubic
interpolations), swraytracing_torch.ops.nufft and the off-grid evaluation
of swraytracing_torch.models.fields against the JAX package on the same
numpy inputs (CPU, float64)."""

import numpy as np
import pytest
import torch

from swraytracing_tpu.ops.grid import SpectralGrid as JGrid
from swraytracing_tpu.ops import interp as jin
from swraytracing_tpu.ops import nufft as jnu
from swraytracing_tpu.models import fields as jfl
from swraytracing_torch.ops.grid import SpectralGrid as TGrid
from swraytracing_torch.ops import interp as tin
from swraytracing_torch.ops import nufft as tnu
from swraytracing_torch.ops import spectral as tsp
from swraytracing_torch.models import fields as tfl

from torch_parity import (NX, L, to_jax, to_torch, to_numpy, assert_close,
                          assert_equal, smooth_fields, random_spectrum)

DX = L / NX


def _positions(n=200, seed=0):
    """Positions over several periods, with the mod/floor edges planted."""
    x = np.random.default_rng(seed).uniform(-3 * L, 3 * L, (2, n))
    x[:, 0] = [-1e-18, L]           # mod gives exactly nx; exactly L
    x[:, 1] = [L, -1e-18]
    x[:, 2] = [np.nextafter(DX, 0), np.nextafter(DX, 1)]
    x[:, 3] = [0.0, np.nextafter(L, 0)]
    return x


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_lagrange_weights(order):
    fr = np.random.default_rng(7).uniform(0, 1, 64)
    got = tin.lagrange_weights(to_torch(fr), order)
    assert got.shape == (2 * order + 2, 64)
    assert_close(got, jin.lagrange_weights(to_jax(fr), order), rtol=1e-14,
                 atol=1e-16)
    np.testing.assert_allclose(to_numpy(got.sum(0)), 1.0, rtol=1e-13)
    # at a node the basis is the Kronecker delta
    at0 = tin.lagrange_weights(torch.zeros(1, dtype=torch.float64), order)
    assert_equal(at0[:, 0], np.eye(2 * order + 2)[order])


@pytest.mark.parametrize("order", [1, 2, 3])
def test_stencil_and_cell_indices_with_edges(order):
    jg, tg = JGrid.square(NX), TGrid.square(NX)
    x = _positions()
    got = tin.stencil_and_weights(to_torch(x[0]), to_torch(x[1]), tg, order)
    want = jin.stencil_and_weights(to_jax(x[0]), to_jax(x[1]), jg, order)
    assert got[0].dtype == torch.int32 and got[0].shape == (2 * order + 2, 200)
    for g, w in zip(got[:2], want[:2]):
        assert_equal(g, w)
        assert 0 <= int(g.min()) and int(g.max()) < NX
    for g, w in zip(got[2:], want[2:]):
        assert_close(g, w, rtol=1e-12, atol=1e-14)
    # x = -1e-18: floor(mod) = nx, wrapped so the stencil sits around 0
    assert got[0][:, 0].tolist() == [(o % NX) for o in
                                     range(-order, order + 2)]
    cg = tin.cell_and_weights(to_torch(x[0]), to_torch(x[1]), tg, order)
    cw = jin.cell_and_weights(to_jax(x[0]), to_jax(x[1]), jg, order)
    for g, w in zip(cg[:2], cw[:2]):
        assert_equal(g, w)
    assert int(cg[0][0]) == 0 and int(cg[1][0]) == 0
    assert_close(cg[2], cw[2], rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_interpolate_stack_and_single(order):
    """36 (or 16, 64) products of O(1) values per packet."""
    jg, tg = JGrid.square(NX), TGrid.square(NX)
    F = smooth_fields(np.random.default_rng(1), 6)
    x = _positions(seed=2)
    got = tin.interpolate_stack(to_torch(F), to_torch(x[0]), to_torch(x[1]),
                                tg, order)
    want = jin.interpolate_stack(to_jax(F), to_jax(x[0]), to_jax(x[1]), jg,
                                 order)
    assert got.shape == (6, 200)
    assert_close(got, want, rtol=1e-12, atol=1e-14)
    one = tin.interpolate(to_torch(F[3]), to_torch(x[0]), to_torch(x[1]), tg,
                          order)
    assert one.shape == (200,)
    assert_equal(one, to_numpy(got[3]))
    assert_close(one, jin.interpolate(to_jax(F[3]), to_jax(x[0]),
                                      to_jax(x[1]), jg, order),
                 rtol=1e-12, atol=1e-14)


def test_interpolation_reproduces_grid_values_and_is_periodic():
    tg = TGrid.square(NX)
    F = to_torch(smooth_fields(np.random.default_rng(3), 2))
    X, Y = tg.meshgrid()
    at_nodes = tin.interpolate_stack(F, to_torch(X.ravel()),
                                     to_torch(Y.ravel()), tg)
    assert_close(at_nodes, to_numpy(F.reshape(2, -1)), atol=1e-13)
    x = to_torch(_positions(seed=4))
    a = tin.interpolate_stack(F, x[0], x[1], tg)
    b = tin.interpolate_stack(F, x[0] + 2 * L, x[1] - L, tg)
    assert_close(a[:, 4:], to_numpy(b[:, 4:]), atol=1e-12)


def test_interpolation_gradients():
    """Autograd through the gather: d/dF (a scatter-add) and d/dx."""
    import jax
    import jax.numpy as jnp
    jg, tg = JGrid.square(NX), TGrid.square(NX)
    F = smooth_fields(np.random.default_rng(5), 6)
    x = _positions(n=50, seed=6)[:, 4:]

    def loss_j(F_, x_):
        return jnp.sum(jnp.sin(jin.interpolate_stack(F_, x_[0], x_[1], jg)))

    want = jax.grad(loss_j, argnums=(0, 1))(to_jax(F), to_jax(x))
    Ft, xt = (to_torch(a).requires_grad_(True) for a in (F, x))
    torch.sin(tin.interpolate_stack(Ft, xt[0], xt[1], tg)).sum().backward()
    assert_close(Ft.grad, want[0], rtol=1e-11, atol=1e-13)
    assert_close(xt.grad, want[1], rtol=1e-10, atol=1e-12)


def test_gridded_flow_at_and_velocity_at():
    jg, tg = JGrid.square(NX), TGrid.square(NX)
    psik = 5.0 * random_spectrum(np.random.default_rng(8), tg)
    jflow = jfl.flow_from_psik(to_jax(psik), jg)
    tflow = tfl.flow_from_psik(to_torch(psik), tg)
    assert_close(tflow.fields, jflow.fields, rtol=1e-12, atol=1e-12)
    x = _positions(seed=9)
    jev = jflow.at(to_jax(x[0]), to_jax(x[1]))
    tev = tflow.at(to_torch(x[0]), to_torch(x[1]), 0.3)  # alpha is ignored
    assert tev._fields == jev._fields
    for name in tev._fields:
        assert_close(getattr(tev, name), getattr(jev, name), rtol=1e-12,
                     atol=1e-12, err_msg=name)
    k = np.random.default_rng(10).normal(0, 3.0, (2, 200))
    assert_close(tev.uv, jev.uv, rtol=1e-12, atol=1e-12)
    assert_close(tev.refraction(to_torch(k)), jev.refraction(to_jax(k)),
                 rtol=1e-12, atol=1e-11)
    u, v = tflow.velocity_at(to_torch(x[0]), to_torch(x[1]))
    assert_equal(u, to_numpy(tev.u))
    assert_equal(v, to_numpy(tev.v))


def test_flow_from_psi_grid():
    jg, tg = JGrid.square(NX), TGrid.square(NX)
    X, Y = tg.meshgrid()
    psi = 0.1 * (np.sin(X) * np.sin(Y) + 0.25 * np.cos(X) * np.cos(Y))
    got = tfl.flow_from_psi_grid(to_torch(psi), tg, order=3)
    want = jfl.flow_from_psi_grid(to_jax(psi), jg, order=3)
    assert got.order == 3 and got.fields.shape == (6, NX, NX)
    assert_close(got.fields, want.fields, rtol=1e-12, atol=1e-13)
    # u = -psi_y, v = psi_x of the analytic streamfunction
    np.testing.assert_allclose(
        to_numpy(got.fields[0]),
        -0.1 * (np.sin(X) * np.cos(Y) - 0.25 * np.cos(X) * np.sin(Y)),
        atol=1e-13)


def test_unported_window_paths_name_their_roadmap_item():
    # the windowed path is ported (held against JAX in
    # tests/test_torch_per_stage.py), and so is the cubic interpolation
    # (held against JAX below): a constant field stays constant
    tg = TGrid.square(NX)
    F = torch.ones(6, NX, NX)
    x = torch.zeros(3)
    W = tin.build_windows(F)
    assert W.shape == (NX * NX, 36 * 6)
    assert torch.allclose(tin.interp_windowed(W, 6, x, x, tg),
                          torch.ones(6, 3))
    assert torch.allclose(tin.interpolate_cubic(F[0], x, x, tg),
                          torch.ones(3))
    assert torch.allclose(tin.interpolate_cubic(F, x, x, tg),
                          torch.ones(6, 3))


def test_cubic_conv_weights_and_interpolate_cubic_match_jax():
    """Keys' cubic-convolution weights and the periodic bicubic
    interpolation against JAX at positions with the mod/floor edges
    planted: the same cell and weights, so values to 1e-13 and the cell
    choice exact (a wrong cell would be O(1) off)."""
    frac = np.random.default_rng(5).uniform(0, 1, 40)
    w = tin._cubic_conv_weights(to_torch(frac))
    assert_close(w, jin._cubic_conv_weights(to_jax(frac)), rtol=1e-15,
                 atol=1e-16)
    np.testing.assert_allclose(to_numpy(w).sum(0), 1.0, rtol=1e-14)
    jg, tg = JGrid.square(NX), TGrid.square(NX)
    F = smooth_fields(np.random.default_rng(6), 3)
    p = _positions(seed=7)
    for f in (F, F[1]):
        got = tin.interpolate_cubic(to_torch(f), to_torch(p[0]),
                                    to_torch(p[1]), tg)
        want = jin.interpolate_cubic(to_jax(f), to_jax(p[0]), to_jax(p[1]),
                                     jg)
        assert_close(got, want, rtol=1e-13, atol=1e-13)


def test_cubic_interpolation_accuracy():
    """tests/test_interp.py's check through the port: interpolate_cubic
    reproduces nodes exactly and converges on smooth fields; the 6-point
    Lagrangian stencil stays more accurate (higher order)."""
    grid = TGrid.square(64)
    X, Y = grid.meshgrid()
    F = to_torch(np.sin(3 * X) * np.cos(2 * Y))
    xg, yg = to_torch(grid.x[5:9]), to_torch(grid.y[11:15])
    got = tin.interpolate_cubic(F, xg, yg, grid)
    np.testing.assert_allclose(to_numpy(got),
                               to_numpy(F)[5:9, 11:15].diagonal(),
                               atol=1e-13)
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 2 * np.pi, 300)
    y = rng.uniform(0, 2 * np.pi, 300)
    exact = np.sin(3 * x) * np.cos(2 * y)
    errc = np.abs(to_numpy(tin.interpolate_cubic(
        F, to_torch(x), to_torch(y), grid)) - exact).max()
    errl = np.abs(to_numpy(tin.interpolate(
        F, to_torch(x), to_torch(y), grid)) - exact).max()
    assert errc < 1e-3
    assert errl < errc  # 6-point Lagrangian beats bicubic


def test_eval_spectrum_matches_jax():
    """ops.nufft: the direct evaluation of a random half-plane spectrum
    and of its gradient at random points, against JAX (rtol 1e-12), and
    its gradient w.r.t. the spectrum and the positions against jax.grad.
    PyTorch's gradient of a real loss w.r.t. a complex input is the
    complex conjugate of jax.grad's."""
    import jax
    import jax.numpy as jnp

    jg, tg = JGrid.square(NX), TGrid.square(NX)
    rng = np.random.default_rng(8)
    fk = random_spectrum(rng, tg)
    x, y = rng.uniform(-3, 9, (2, 60))
    got = tnu.eval_spectrum_and_grad_at(to_torch(fk), to_torch(x),
                                        to_torch(y), tg)
    want = jnu.eval_spectrum_and_grad_at(to_jax(fk), to_jax(x), to_jax(y),
                                         jg)
    scale = float(np.abs(to_numpy(want[1])).max())
    for g, w in zip(got, want):
        assert_close(g, w, rtol=1e-12, atol=1e-13 * scale)
    assert_close(tnu.eval_spectrum_at(to_torch(fk), to_torch(x),
                                      to_torch(y), tg),
                 jnu.eval_spectrum_at(to_jax(fk), to_jax(x), to_jax(y), jg),
                 rtol=1e-12, atol=1e-13)

    def jloss(fk_, x_):
        f, fx, fy = jnu.eval_spectrum_and_grad_at(fk_, x_, to_jax(y), jg)
        return jnp.sum(f ** 2 + fx * fy)

    jgf, jgx = jax.grad(jloss, argnums=(0, 1))(to_jax(fk), to_jax(x))
    tfk = to_torch(fk).requires_grad_(True)
    tx = to_torch(x).requires_grad_(True)
    f, fx, fy = tnu.eval_spectrum_and_grad_at(tfk, tx, to_torch(y), tg)
    gf, gx = torch.autograd.grad((f ** 2 + fx * fy).sum(), (tfk, tx))
    assert_close(gf, np.conj(np.asarray(jgf)), rtol=1e-11,
                 atol=1e-12 * float(np.abs(np.asarray(jgf)).max()))
    assert_close(gx, jgx, rtol=1e-11, atol=1e-12)


def test_nufft_matches_grid():
    """tests/test_interp.py's check through the port: at grid points the
    direct evaluation equals the field, and its gradient the analytic
    derivative."""
    grid = TGrid.square(32)
    X, Y = grid.meshgrid()
    f = np.cos(2 * X + 3 * Y) + 0.3 * np.sin(5 * Y)
    fk = tsp.to_spectral(to_torch(f), grid)
    xs, ys = to_torch(X.ravel()), to_torch(Y.ravel())
    vals = tnu.eval_spectrum_at(fk, xs, ys, grid)
    np.testing.assert_allclose(to_numpy(vals), f.ravel(), atol=1e-10)
    np.testing.assert_allclose(to_numpy(vals),
                               to_numpy(tsp.to_grid(fk, grid)).ravel(),
                               atol=1e-12)
    v, vx, vy = tnu.eval_spectrum_and_grad_at(fk, xs, ys, grid)
    np.testing.assert_allclose(to_numpy(vx),
                               (-2 * np.sin(2 * X + 3 * Y)).ravel(),
                               atol=1e-9)
    np.testing.assert_allclose(
        to_numpy(vy),
        (-3 * np.sin(2 * X + 3 * Y) + 1.5 * np.cos(5 * Y)).ravel(),
        atol=1e-9)


def test_against_nufft():
    """tests/test_interp.py's check through the port: the Lagrangian
    interpolation converges to the direct spectral evaluation of a smooth
    band-limited field (6-point truncation error ~6e-4 relative)."""
    grid = TGrid.square(128)
    rng = np.random.default_rng(2)
    fk = np.zeros(grid.spectral_shape, dtype=complex)
    for k in range(-6, 7):
        for m in range(0, 7):
            fk[k % grid.nx, m] = (rng.standard_normal()
                                  + 1j * rng.standard_normal()) * 0.1
    fk[:, 0] = 0
    fk = to_torch(fk * grid.nyquist_mask)
    f = tsp.to_grid(fk, grid)
    xp = to_torch(rng.uniform(-3, 3, 100))
    yp = to_torch(rng.uniform(-3, 3, 100))
    fi = tin.interpolate(f, xp, yp, grid)
    fs = tnu.eval_spectrum_at(fk, xp, yp, grid)
    np.testing.assert_allclose(to_numpy(fi), to_numpy(fs), atol=5e-5)
