"""swraytracing_torch.ops.march_rays (the module that holds the frozen-flow
march kernel) and swraytracing_torch.models.frozen against the JAX package
on the same numpy inputs (CPU, float64). On the CPU the port's march_rays
runs the kernel's plain version; the JAX side runs its XLA reference and
the Pallas kernel in interpret mode."""

import numpy as np
import pytest
import torch

from swraytracing_tpu.ops.grid import SpectralGrid as JGrid
from swraytracing_tpu.ops import pallas_ray as jpr
from swraytracing_tpu.models import frozen as jfz
from swraytracing_tpu.models.dispersion import Dispersion as JDispersion
from swraytracing_tpu.models.fields import flow_from_psi_grid as j_flow
from swraytracing_torch.ops.grid import SpectralGrid as TGrid
from swraytracing_torch.ops import march_rays as tmr
from swraytracing_torch.models import frozen as tfz
from swraytracing_torch.models.dispersion import Dispersion as TDispersion
from swraytracing_torch.models.fields import (GriddedFlow,
                                              flow_from_psi_grid as t_flow)

from torch_parity import to_jax, to_torch, to_numpy, assert_close, assert_equal

JD, TD = JDispersion(f=3.0, Cg=1.0), TDispersion(f=3.0, Cg=1.0)
N = 64
L = 2 * np.pi

# 50 Strang steps, each one 6x6 stencil on six fields and two drifts, on
# |x| < 10, |k| = 8: the tolerance the JAX package holds its kernel to.
ATOL = 1e-10


def _setup(n_packets=100, seed=0):
    """The steady cellular flow and ring of wavevectors of the JAX
    package's own test of its kernel, as numpy."""
    tg = TGrid.square(N)
    X, Y = tg.meshgrid()
    psi = 0.1 * (np.sin(X) * np.sin(Y) + 0.25 * np.cos(X) * np.cos(Y))
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(0, L, (2, n_packets))
    ang = 2 * np.pi * np.arange(n_packets) / n_packets
    k0 = 8.0 * np.stack([np.cos(ang), np.sin(ang)], 0)
    return JGrid.square(N), tg, psi, x0, k0


@pytest.mark.parametrize("order", [1, 2, 3])
def test_march_rays_reference_matches_jax(order):
    jg, tg, psi, x0, k0 = _setup()
    jF = j_flow(to_jax(psi), jg).fields
    tF = t_flow(to_torch(psi), tg).fields
    want = jpr.march_rays_reference(jF, to_jax(x0), to_jax(k0), jg, JD,
                                    0.005, 50, order=order)
    got = tmr.march_rays_reference(tF, to_torch(x0), to_torch(k0), tg, TD,
                                   0.005, 50, order=order)
    assert_close(got[0], want[0], atol=ATOL)
    assert_close(got[1], want[1], atol=ATOL)


@pytest.mark.parametrize("n_packets,block", [(100, 64), (70, 32)])
def test_march_rays_matches_pallas_interpret(n_packets, block):
    """Against the TPU kernel itself (interpret mode), with a packet count
    that is no multiple of its block. The entry point takes the plain
    version on CPU tensors."""
    jg, tg, psi, x0, k0 = _setup(n_packets)
    x0[:, 0] = [-1e-18, L]            # the mod/floor edges
    x0[:, 1] = [np.nextafter(L / N, 0), np.nextafter(L / N, 1)]
    jF = j_flow(to_jax(psi), jg).fields
    tF = t_flow(to_torch(psi), tg).fields
    want = jpr.march_rays_pallas(jF, to_jax(x0), to_jax(k0), jg, JD, 0.005,
                                 50, block=block, interpret=True)
    got = tmr.march_rays(tF, to_torch(x0), to_torch(k0), tg, TD, 0.005, 50)
    assert got[0].shape == (2, n_packets)
    assert_close(got[0], want[0], atol=ATOL)
    assert_close(got[1], want[1], atol=ATOL)
    ref = tmr.march_rays_reference(tF, to_torch(x0), to_torch(k0), tg, TD,
                                   0.005, 50)
    assert_equal(got[0], to_numpy(ref[0]))
    assert_equal(got[1], to_numpy(ref[1]))


def test_march_rays_conserves_absolute_frequency():
    """omega + U.k is the invariant of a steady flow: 500 steps keep it to
    2e-3, the bound of the JAX package's test of its kernel."""
    _, tg, psi, x0, k0 = _setup(32)
    flow = t_flow(to_torch(psi), tg)
    x0, k0 = to_torch(x0), to_torch(k0)
    xN, kN = tmr.march_rays(flow.fields, x0, k0, tg, TD, 0.004, 500)
    Om0 = TD.absolute_frequency(k0, flow.at(x0[0], x0[1]).uv)
    OmN = TD.absolute_frequency(kN, flow.at(xN[0], xN[1]).uv)
    err = float(((OmN - Om0) / Om0).abs().max())
    assert err < 2e-3, err


def test_march_rays_zero_steps_and_cuda_wrapper_refuses_cpu():
    _, tg, psi, x0, k0 = _setup(10)
    F = t_flow(to_torch(psi), tg).fields
    x0, k0 = to_torch(x0), to_torch(k0)
    same = tmr.march_rays(F, x0, k0, tg, TD, 0.005, 0)
    assert_equal(same[0], to_numpy(x0))
    with pytest.raises(ValueError, match="CUDA"):
        tmr.march_rays_cuda(F, x0, k0, tg, TD, 0.005, 1)
    with pytest.raises(ValueError, match="order"):
        tmr.march_rays_cuda(F, x0, k0, tg, TD, 0.005, 1, order=4)
    assert tmr.march_rays_cuda.launches == 0


def test_ring_ics_equal():
    jx, jk = jfz.ring_ics(50, 2.0, JD, seed=7)
    tx, tk = tfz.ring_ics(50, 2.0, TD, seed=7, device="cpu",
                          dtype=torch.float64)
    assert_equal(tx, jx)
    assert_close(tk, jk, rtol=1e-15)
    np.testing.assert_allclose(to_numpy(TD.omega(tk)) / TD.f, 2.0, rtol=1e-14)
    assert tfz.ring_ics(4, 2.0, TD, device="cpu")[0].dtype == torch.float32


@pytest.mark.parametrize("stepper", ["symplectic", "yoshida4", "rk4", "rk23"])
def test_raytrace_frozen_matches_jax(stepper):
    jg, tg, psi, x0, k0 = _setup(40, seed=1)
    want = jfz.raytrace_frozen(j_flow(to_jax(psi), jg), to_jax(x0),
                               to_jax(k0), JD, 0.005, 40, save_every=10,
                               stepper=stepper)
    got = tfz.raytrace_frozen(t_flow(to_torch(psi), tg), to_torch(x0),
                              to_torch(k0), TD, 0.005, 40, save_every=10,
                              stepper=stepper)
    assert got._fields == want._fields
    assert got.x.shape == (4, 2, 40) and got.omega.shape == (4, 40)
    assert_close(got.x, want.x, atol=ATOL)
    assert_close(got.k, want.k, atol=ATOL)
    assert_close(got.t, want.t, rtol=1e-14)
    assert_close(got.omega, want.omega, atol=ATOL)
    assert_close(got.omega_abs0, want.omega_abs0, atol=ATOL)
    assert_close(got.omega_abs, want.omega_abs, atol=ATOL)
    # the drifts themselves are 1e-10 .. 1e-5: compare them in absolute
    assert_close(got.conservation_error, want.conservation_error,
                 atol=1e-11)
    assert float(got.conservation_error.max()) < 1e-4


def test_raytrace_frozen_last_frame_is_the_fused_march():
    """raytrace_frozen(stepper='symplectic') steps with the same
    arithmetic as march_rays' plain version."""
    _, tg, psi, x0, k0 = _setup(30, seed=2)
    flow = GriddedFlow(fields=t_flow(to_torch(psi), tg).fields, grid=tg)
    x0, k0 = to_torch(x0), to_torch(k0)
    res = tfz.raytrace_frozen(flow, x0, k0, TD, 0.005, 20, save_every=20)
    xN, kN = tmr.march_rays(flow.fields, x0, k0, tg, TD, 0.005, 20)
    assert_equal(res.x[-1], to_numpy(xN))
    assert_equal(res.k[-1], to_numpy(kN))
    none = tfz.raytrace_frozen(flow, x0, k0, TD, 0.005, 5, save_every=20)
    assert none.x.shape == (0, 2, 30) and none.omega_abs.shape == (0, 30)


def test_raytrace_pv_snapshot_matches_jax(tmp_path):
    """Config 3 (tests/test_frozen.py): a QG PV frame written to .bin by
    the port's binio, reloaded by the frozen-snapshot driver of each
    package from the same file; the port's frames equal JAX's (atol 1e-9
    after 1000 steps) and the invariant holds in the steady flow."""
    from swraytracing_torch.io import binio
    from swraytracing_torch.models.qg import initial_q_ring
    from swraytracing_torch.ops import spectral as tsp

    nx = 64
    tg = TGrid.square(nx)
    qk = initial_q_ring(3, tg, 0.3, 3.0, device="cpu", dtype=torch.float64)
    q = to_numpy(tsp.to_grid(qk, tg))
    binio.write_field(q, tmp_path / "pv", 1)
    binio.write_field(q * 0.5, tmp_path / "pv", 2)
    kw = dict(frame=2, nx=nx, Kd2=3.0, n_packets=16, dt=0.002, nsteps=1000,
              save_every=250)
    got = tfz.raytrace_pv_snapshot(tmp_path / "pv", disp=TD, device="cpu",
                                   dtype=torch.float64, **kw)
    want = jfz.raytrace_pv_snapshot(tmp_path / "pv", disp=JD, **kw)
    assert got.x.shape == (4, 2, 16) and got.x.dtype == torch.float64
    assert float(got.conservation_error[-1]) < 2e-2
    assert bool(torch.isfinite(got.x).all())
    assert_close(got.x, want.x, atol=1e-9)
    assert_close(got.k, want.k, atol=1e-9)
    assert_close(got.conservation_error, want.conservation_error, atol=1e-11)


def test_raytrace_frozen_switches_to_windows_as_jax(monkeypatch):
    """From ops.interp._WINDOW_MIN_NP packets on, raytrace_frozen builds the
    gridded flow's windows once and steps through them, as the JAX package
    does (the threshold lowered to 16 in both packages here): the frames
    equal JAX's (atol 1e-10) and the stencil run's (atol 1e-12)."""
    from swraytracing_tpu.ops import interp as jin
    from swraytracing_torch.ops import interp as tin

    jg, tg, psi, x0, k0 = _setup(40, seed=3)
    args = (TD, 0.005, 40)
    stencil = tfz.raytrace_frozen(t_flow(to_torch(psi), tg), to_torch(x0),
                                  to_torch(k0), *args, save_every=10)
    built = []
    windowed = GriddedFlow.windowed
    monkeypatch.setattr(GriddedFlow, "windowed",
                        lambda self: built.append(1) or windowed(self))
    monkeypatch.setattr(tin, "_WINDOW_MIN_NP", 16)
    monkeypatch.setattr(jin, "_WINDOW_MIN_NP", 16)
    got = tfz.raytrace_frozen(t_flow(to_torch(psi), tg), to_torch(x0),
                              to_torch(k0), *args, save_every=10)
    assert built == [1]
    want = jfz.raytrace_frozen(j_flow(to_jax(psi), jg), to_jax(x0),
                               to_jax(k0), JD, 0.005, 40, save_every=10)
    for name in ("x", "k", "omega_abs"):
        assert_close(getattr(got, name), getattr(want, name), atol=ATOL)
        assert_close(getattr(got, name), to_numpy(getattr(stencil, name)),
                     atol=1e-12)
