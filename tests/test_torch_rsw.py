"""swraytracing_torch.models.rsw against the JAX package on the same numpy
inputs (CPU, float64): every variant of the swk family, swknd with
particles, the diagnostics, the state carried across the packages, and
what a float32 run keeps in float32."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from swraytracing_tpu.ops.grid import SpectralGrid as JGrid
from swraytracing_tpu.models import rsw as jr
from swraytracing_tpu.models import examples as jex
from swraytracing_tpu.models.exact_linear import plane_wave_ic
from swraytracing_torch.ops.grid import SpectralGrid as TGrid
from swraytracing_torch.models import rsw as tr
from swraytracing_torch.models import examples as tex
from swraytracing_torch import convert

from torch_parity import assert_close, assert_equal, to_numpy

F, CG = 3.0, 1.0
NX = 32
# frames: float64 FFTs and products through 40 AB3 steps of O(0.3) fields
ATOL_FRAMES = 1e-10
RTOL_ENERGY = 1e-10
F64 = dict(device="cpu", dtype=torch.float64)


def _grids(nx=NX):
    return JGrid.square(nx), TGrid.square(nx)


def _ic(nx=NX):
    jg, _ = _grids(nx)
    (u, v, h), _ = jex.wave_and_geostrophic_spectrum_ic(jg, F, CG)
    return u, v, h


def _backgrounds(kind, jg, tg):
    if kind is None:
        return None, None
    if kind == "zero":
        jz = jnp.zeros(jg.shape)
        tz = torch.zeros(tg.shape, dtype=torch.float64)
        return (lambda t: (jz, jz)), (lambda t: (tz, tz))
    return (jex.translating_cs_background(jg, F, CG),
            tex.translating_cs_background(tg, F, CG))


def _check_run(got, want, scale=1.0):
    """Frames and final state at ATOL_FRAMES (times `scale`, the fields'
    magnitude where they are not O(1))."""
    tst, S, ts, ke, pe = got[:5]
    jst, JS, Jts, Jke, Jpe = want[:5]
    assert_close(S, JS, atol=ATOL_FRAMES * scale)
    assert_close(ts, Jts, atol=1e-13)
    assert_close(ke, Jke, rtol=RTOL_ENERGY)
    assert_close(pe, Jpe, rtol=RTOL_ENERGY)
    assert_close(tst.Sk, jst.Sk, atol=ATOL_FRAMES * scale)
    assert_close(tst.dt, jst.dt, rtol=1e-12)
    assert tst.step == int(jst.step)
    assert bool(tst.blown) == bool(jst.blown)
    if len(got) == 6:
        assert_close(got[5], want[5], atol=ATOL_FRAMES)


def test_rsw_filters_exact():
    jg, tg = _grids()
    p = tr.RSWParams(f=F, Cg=CG, hyper_order=4, nutune=2.0)
    for a, b in zip(tr.rsw_filters(tg, p),
                    jr.rsw_filters(jg, jr.RSWParams(*p))):
        assert_equal(a, b)


def test_rsw_init_parity():
    jg, tg = _grids()
    u, v, h = _ic()
    p = tr.RSWParams(f=F, Cg=CG)
    got = tr.rsw_init(u, v, h, tg, p, t0=2.5, **F64)
    want = jr.rsw_init(u, v, h, jg, jr.RSWParams(*p), t0=2.5)
    assert_close(got.Sk, want.Sk, atol=1e-15)
    assert_equal(got.rhs_m1, np.zeros_like(want.Sk))
    assert_close(got.dt, want.dt, rtol=1e-15)
    assert float(got.t) == 2.5 and got.t.dtype == torch.float64
    assert got.step == 0 and not bool(got.blown)


@pytest.mark.parametrize("kw,background", [
    ({}, None),                                   # swk
    ({}, "zero"),                                 # swkU, zero background
    ({}, "tc"),                                   # swkU_tc
    (dict(killpv=True), "zero"),                  # swkU killpv
    (dict(pv_damp_rate=0.1), "zero"),             # swkUqx
    (dict(bernoulli_half=False), None),           # swks
    (dict(dealias=False, hyper_order=4), None),   # aliased products
], ids=["swk", "swkU", "swkU_tc", "killpv", "pv_damp", "swks", "aliased"])
def test_simulate_rsw_variants(kw, background):
    jg, tg = _grids()
    u, v, h = _ic()
    p = tr.RSWParams(f=F, Cg=CG, **kw)
    jp = jr.RSWParams(*p)
    jb, tb = _backgrounds(background, jg, tg)
    want = jr.simulate_rsw(jr.rsw_init(u, v, h, jg, jp), jg, jp, 40, 10,
                           background_fn=jb)
    got = tr.simulate_rsw(tr.rsw_init(u, v, h, tg, p, **F64), tg, p, 40, 10,
                          background_fn=tb)
    _check_run(got, want)
    assert got[1].shape == (4, 3, NX, NX)


def test_simulate_rsw_particles():
    jg, tg = _grids()
    u, v, h = _ic()
    p = tr.RSWParams(f=F, Cg=CG)
    jp = jr.RSWParams(*p)
    xp0 = np.random.default_rng(1).uniform(0.0, 2 * np.pi, (2, 24))
    want = jr.simulate_rsw(jr.rsw_init(u, v, h, jg, jp), jg, jp, 30, 10,
                           Xp0=jnp.asarray(xp0), particle_vel_scale=0.7)
    got = tr.simulate_rsw(tr.rsw_init(u, v, h, tg, p, **F64), tg, p, 30, 10,
                          Xp0=xp0, particle_vel_scale=0.7)
    assert len(got) == 6 and got[5].shape == (3, 2, 24)
    _check_run(got, want)


def test_blown_state_freezes():
    """Umax > 1e6 sets the sticky flag at the first step: dt 0 and t
    frozen from then on (the filter still acts), as in the JAX package.
    The fields are O(1e7) here, so the frames compare relative to that."""
    jg, tg = _grids()
    u, v, h = _ic()
    u = u * 1e7
    p = tr.RSWParams(f=F, Cg=CG)
    jp = jr.RSWParams(*p)
    want = jr.simulate_rsw(jr.rsw_init(u, v, h, jg, jp), jg, jp, 6, 3)
    got = tr.simulate_rsw(tr.rsw_init(u, v, h, tg, p, **F64), tg, p, 6, 3)
    assert bool(got[0].blown) and float(got[0].dt) == 0.0
    assert float(got[0].t) == 0.0
    _check_run(got, want, scale=float(np.abs(u).max()))


def test_swknd_with_particles():
    jg, _ = _grids()
    u, v, h = plane_wave_ic(jg, 1.0, 1.0, 2, 1, eta0=0.05)
    kw = dict(ep=0.1, gam=0.7, nsteps=30, save_every=10, np_particles=8)
    JS, Jts, Jke, Jpe, Jxp = jr.swknd(jnp.asarray(u), jnp.asarray(v),
                                      jnp.asarray(h), **kw)
    S, ts, ke, pe, xp = tr.swknd(u, v, h, **kw, **F64)
    assert_close(S, JS, atol=ATOL_FRAMES)
    assert_close(ts, Jts, atol=1e-12)
    assert_close(ke, Jke, rtol=RTOL_ENERGY)
    assert_close(pe, Jpe, rtol=RTOL_ENERGY)
    assert xp.shape == (3, 2, 64)
    assert_close(xp, Jxp, atol=ATOL_FRAMES)
    none = tr.swknd(u, v, h, 0.1, 0.7, 10, 10, **F64)
    assert none[4] is None


def test_diagnostics_parity():
    jg, tg = _grids()
    u, v, h = _ic()
    p = tr.RSWParams(f=F, Cg=CG)
    jp = jr.RSWParams(*p)
    tu, tv, th = (torch.tensor(a) for a in (u, v, h))
    ju, jv, jh = (jnp.asarray(a) for a in (u, v, h))
    for a, b in zip(tr.energy(tu, tv, th, p), jr.energy(ju, jv, jh, jp)):
        assert_close(a, b, rtol=1e-13)
    for a, b in zip(tr.potential_vorticity(tu, tv, th, tg, p),
                    jr.potential_vorticity(ju, jv, jh, jg, jp)):
        assert_close(a, b, atol=1e-13)
    got = tr.wave_vortex_decompose(tu, tv, th, tg, p)
    want = jr.wave_vortex_decompose(ju, jv, jh, jg, jp)
    for gs, ws in zip(got, want):
        for a, b in zip(gs, ws):
            assert_close(a, b, atol=1e-14)
    spec = tr.wave_vortex_spectra(tu, tv, th, tg, p)
    jspec = jr.wave_vortex_spectra(ju, jv, jh, jg, jp)
    assert sorted(spec) == sorted(jspec)
    for key in spec:
        assert_close(spec[key], jspec[key], rtol=1e-10, atol=1e-18)


def test_advect_particles_parity():
    jg, tg = _grids(64)
    X, Y = tg.meshgrid()
    u = np.sin(Y) * np.cos(X)
    v = -np.sin(X) * np.cos(Y)
    xp = np.random.default_rng(1).uniform(0.5, 2.5, (2, 16))
    want, got = jnp.asarray(xp), torch.tensor(xp)
    for _ in range(20):
        want = jr.advect_particles(want, jnp.asarray(u), jnp.asarray(v), jg,
                                   0.02)
        got = tr.advect_particles(got, torch.tensor(u), torch.tensor(v), tg,
                                  0.02)
    assert_close(got, want, atol=1e-13)


def test_state_continues_across_packages():
    """JAX runs 20 steps; the port continues its state (through
    convert.rsw_state_from_numpy) for 20 more; the result is JAX's 40-step
    run. And the state comes back to numpy as it went."""
    jg, tg = _grids()
    u, v, h = _ic()
    p = tr.RSWParams(f=F, Cg=CG)
    jp = jr.RSWParams(*p)
    j0 = jr.rsw_init(u, v, h, jg, jp)
    j20 = jr.simulate_rsw(j0, jg, jp, 20, 20)[0]
    j40 = jr.simulate_rsw(j0, jg, jp, 40, 40)[0]
    tree = {name: np.asarray(getattr(j20, name))
            for name in ("Sk", "rhs_m1", "rhs_m2", "t", "dt", "step",
                         "blown")}
    st = convert.rsw_state_from_numpy(tree, **F64)
    assert st.step == 20 and st.t.dtype == torch.float64
    back = convert.rsw_state_to_numpy(st)
    for name, a in tree.items():
        assert_equal(back[name], a, name)
    t40 = tr.simulate_rsw(st, tg, p, 20, 20)[0]
    assert_close(t40.Sk, j40.Sk, atol=ATOL_FRAMES)
    assert_close(t40.rhs_m1, j40.rhs_m1, atol=ATOL_FRAMES)
    assert_close(t40.t, j40.t, atol=1e-13)
    assert t40.step == 40


@pytest.mark.parametrize("background", [None, "tc"])
def test_float32_run_stays_float32(background):
    """Every constant a step multiplies by is built in the state's dtype:
    a float32 run's frames are float32, its spectra complex64, its t
    float64."""
    jg, tg = _grids()
    u, v, h = _ic()
    p = tr.RSWParams(f=F, Cg=CG, killpv=background is not None)
    _, tb = _backgrounds(background, jg, tg)
    st = tr.rsw_init(u, v, h, tg, p, device="cpu", dtype=torch.float32)
    xp0 = np.random.default_rng(2).uniform(0, 6, (2, 8))
    st, S, ts, ke, pe, xp = tr.simulate_rsw(st, tg, p, 4, 2,
                                            background_fn=tb, Xp0=xp0)
    assert st.Sk.dtype == st.rhs_m1.dtype == torch.complex64
    assert S.dtype == ke.dtype == pe.dtype == xp.dtype == torch.float32
    assert st.dt.dtype == torch.float32
    assert ts.dtype == st.t.dtype == torch.float64
    S, ts, ke, pe, xp = tr.swknd(u, v, h, 0.1, 0.7, 4, 2, np_particles=4,
                                 device="cpu", dtype=torch.float32)
    assert S.dtype == xp.dtype == ke.dtype == torch.float32
    spec = tr.wave_vortex_spectra(*(torch.tensor(a, dtype=torch.float32)
                                    for a in (u, v, h)), tg, p)
    assert all(a.dtype == torch.float32 for a in spec.values())


def test_float32_model_time_c3():
    """ROADMAP C3 (C2 for the RSW solvers): the JAX package keeps t in the
    state's real type, so a float32 run rounds t + dt to float32 every
    step; the port sums t in float64 from the steps' float32 dts. 20 steps
    from t = 1500 at nx=32, with a small-amplitude wave whose speed stays
    below Cmax, so every step has the same dt."""
    jg, tg = _grids()
    u, v, h = plane_wave_ic(jg, F, CG, 2, 1, eta0=0.05)
    t0, n = 1500.0, 20
    with jax.enable_x64(False):
        jp = jr.RSWParams(f=F, Cg=CG)
        js = jr.rsw_init(*(a.astype(np.float32) for a in (u, v, h)), jg, jp,
                         t0=t0)
        assert js.Sk.dtype == jnp.complex64
        js = jr.simulate_rsw(js, jg, jp, n, n)[0]
        assert js.t.dtype == jnp.float32
        jt, jdt = float(js.t), float(js.dt)
    exact = t0 + n * jdt
    assert abs(jt - exact) > 0.05 * jdt          # 0.053 dt long
    p = tr.RSWParams(f=F, Cg=CG)
    st = tr.rsw_init(u, v, h, tg, p, t0=t0, device="cpu",
                     dtype=torch.float32)
    st, _, ts, _, _ = tr.simulate_rsw(st, tg, p, n, n)
    assert float(st.dt) == jdt                   # the same float32 dt
    summed = t0
    for _ in range(n):
        summed += float(st.dt)
    assert float(st.t) == summed
    assert float(st.t) == pytest.approx(exact, rel=1e-15)
    assert float(ts[-1]) == float(st.t)
    assert to_numpy(ts).dtype == np.float64
