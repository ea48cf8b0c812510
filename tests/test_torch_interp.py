"""swraytracing_torch.ops.interp and the off-grid evaluation of
swraytracing_torch.models.fields against the JAX package on the same numpy
inputs (CPU, float64)."""

import numpy as np
import pytest
import torch

from swraytracing_tpu.ops.grid import SpectralGrid as JGrid
from swraytracing_tpu.ops import interp as jin
from swraytracing_tpu.models import fields as jfl
from swraytracing_torch.ops.grid import SpectralGrid as TGrid
from swraytracing_torch.ops import interp as tin
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
    # tests/test_torch_per_stage.py); the cubic interpolation is not
    tg = TGrid.square(NX)
    F = torch.ones(6, NX, NX)
    x = torch.zeros(3)
    W = tin.build_windows(F)
    assert W.shape == (NX * NX, 36 * 6)
    assert torch.allclose(tin.interp_windowed(W, 6, x, x, tg),
                          torch.ones(6, 3))
    with pytest.raises(NotImplementedError, match="A12"):
        tin.interpolate_cubic(F[0], x, x, tg)
