"""swraytracing_torch.models.{exact_linear, examples, examples_1d} against
the JAX package on the same inputs (CPU, float64).

The IC functions that are numpy in both packages must agree exactly. Those
that take a spectral transform (geostrophic_ic and the IC functions that call
it, zero_pv_adjustment_ic, doppler_refract_wave_sw, the background of
swkU_tc) agree to FFT_ATOL: each package's CPU FFT and fused arithmetic
round in its own order, a few ulp of O(1) values (the same operations
applied one by one agree bit for bit; tests/test_torch_cgrid.py shows it
for the C-grid)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from swraytracing_tpu.ops.grid import SpectralGrid as JGrid
from swraytracing_tpu.models import exact_linear as jel
from swraytracing_tpu.models import examples as jex
from swraytracing_tpu.models import examples_1d as jex1
from swraytracing_torch.ops.grid import SpectralGrid as TGrid
from swraytracing_torch.models import exact_linear as tel
from swraytracing_torch.models import examples as tex
from swraytracing_torch.models import examples_1d as tex1

from torch_parity import assert_close, assert_equal, to_numpy

F, CG = 3.0, 1.0
FFT_ATOL = 1e-14


def _grids(nx=32):
    return JGrid.square(nx), TGrid.square(nx)


def _equal_tree(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal_tree(g, w)
    else:
        assert isinstance(got, np.ndarray) or np.isscalar(got), type(got)
        assert_equal(got, np.asarray(want))


def _close_tree(got, want, atol):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close_tree(g, w, atol)
    else:
        assert isinstance(got, np.ndarray), type(got)
        assert_close(got, np.asarray(want), atol=atol)


def test_linear_sw_solution_exact():
    jg, tg = _grids()
    rng = np.random.default_rng(0)
    u0, v0, h0 = (rng.standard_normal(tg.shape) for _ in range(3))
    times = [0.0, 0.3, 1.1]
    _equal_tree(tel.linear_sw_solution(u0, v0, h0, F, CG, times, tg),
                jel.linear_sw_solution(u0, v0, h0, F, CG, times, jg))
    a, b, c = (rng.standard_normal(64) for _ in range(3))
    _equal_tree(tel.linear_sw_solution_1d(a, b, c, F, CG, times),
                jel.linear_sw_solution_1d(a, b, c, F, CG, times))
    # t = 0 returns the initial condition (the reference's getSk defect
    # is not replicated)
    u, v, h = tel.linear_sw_solution(u0, v0, h0, F, CG, [0.0], tg)
    np.testing.assert_allclose(h[0], h0, atol=1e-10)


@pytest.mark.parametrize("k,l,sign,phase", [(3, 0, 1, 0.0), (2, -1, -1, 0.7)])
def test_plane_wave_ic_exact(k, l, sign, phase):
    jg, tg = _grids()
    _equal_tree(tel.plane_wave_ic(tg, F, CG, k, l, 0.01, sign, phase),
                jel.plane_wave_ic(jg, F, CG, k, l, 0.01, sign, phase))


def test_geostrophic_ic_parity_and_devices():
    jg, tg = _grids()
    X, Y = tg.meshgrid()
    psi = 0.1 * np.sin(X) * np.sin(2 * Y) + 0.05 * np.cos(3 * X)
    want = jel.geostrophic_ic(jg, F, CG, jnp.asarray(psi))
    got = tel.geostrophic_ic(tg, F, CG, psi)          # numpy: host, numpy
    _close_tree(got, want, FFT_ATOL)
    got_t = tel.geostrophic_ic(tg, F, CG, torch.tensor(psi))
    for g, n in zip(got_t, got):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float64
        np.testing.assert_array_equal(to_numpy(g), n)
    f32 = tel.geostrophic_ic(tg, F, CG, torch.tensor(psi,
                                                      dtype=torch.float32))
    assert all(a.dtype == torch.float32 for a in f32)


@pytest.mark.parametrize("name,args,kwargs", [
    ("wave_packet_ic", (F, CG), dict(k0=4, theta=0.3)),
    ("inertial_oscillation_ic", (), dict(u0=0.2)),
    ("counter_propagating_ic", (F, CG), dict(k_int=3)),
    ("wave_bath_ic", (F, CG), dict(seed=4)),
])
def test_numpy_ics_exact(name, args, kwargs):
    jg, tg = _grids()
    _equal_tree(getattr(tex, name)(tg, *args, **kwargs),
                getattr(jex, name)(jg, *args, **kwargs))


@pytest.mark.parametrize("name,args,kwargs", [
    ("zero_pv_adjustment_ic", (F, CG), {}),
    ("rigid_lid_vortex_ic", (F, CG), dict(sigma=0.7)),
    ("wave_and_geostrophic_spectrum_ic", (F, CG), dict(seed=2)),
])
def test_spectral_ics(name, args, kwargs):
    jg, tg = _grids()
    _close_tree(getattr(tex, name)(tg, *args, **kwargs),
                getattr(jex, name)(jg, *args, **kwargs), FFT_ATOL)


def test_wave_and_geostrophic_spectrum_wave_part_exact():
    """The wave bath is numpy in both packages and draws the same numpy
    stream: total minus geostrophic part is the wave bath exactly up to the
    geostrophic part's own rounding."""
    jg, tg = _grids()
    (u, v, h), (ug, vg, hg) = tex.wave_and_geostrophic_spectrum_ic(tg, F,
                                                                   CG)
    uw, vw, hw = tex.wave_bath_ic(tg, F, CG)
    assert_equal(uw, jex.wave_bath_ic(jg, F, CG)[0])
    np.testing.assert_allclose(u - ug, uw, atol=1e-15)
    np.testing.assert_allclose(h - hg, hw, atol=1e-15)


def test_translating_cs_background_parity():
    """background_fn(t) on the device and in the dtype of its t, equal to
    the JAX package's at the same times; max|Psi| = ag every time."""
    jg, tg = _grids()
    jfn = jex.translating_cs_background(jg, F, CG, ag=0.3, raXT=0.2)
    tfn = tex.translating_cs_background(tg, F, CG, ag=0.3, raXT=0.2)
    for t in (0.0, 0.37, 5.2):
        U, V = tfn(torch.tensor(t, dtype=torch.float64))
        JU, JV = jfn(jnp.asarray(t))
        assert_close(U, JU, atol=FFT_ATOL)
        assert_close(V, JV, atol=FFT_ATOL)
    U32, V32 = tfn(torch.tensor(0.37, dtype=torch.float32))
    assert U32.dtype == V32.dtype == torch.float32


def test_doppler_fields_exact():
    jg, tg = _grids()
    times = [0.0, 0.4]
    kw = dict(k_range=range(3, 6), l_range=range(5, 7), seed=3)
    _equal_tree(tex.doppler_wave_field(tg, F, CG, times, **kw),
                jex.doppler_wave_field(jg, F, CG, times, **kw))
    _equal_tree(tex.doppler_refract_wave_field(tg, F, CG, times, **kw),
                jex.doppler_refract_wave_field(jg, F, CG, times, **kw))


def test_doppler_refract_wave_sw_parity():
    jg, tg = _grids()
    (u, v, h), _ = jex.wave_and_geostrophic_spectrum_ic(jg, F, CG)
    kw = dict(k_range=range(3, 6), l_range=range(5, 7), seed=3)
    want = jex.doppler_refract_wave_sw(u, v, h, jg, F, CG, [0.0, 0.4], **kw)
    got = tex.doppler_refract_wave_sw(u, v, h, tg, F, CG, [0.0, 0.4], **kw)
    _close_tree(got, want, FFT_ATOL)
    again = tex.doppler_refract_wave_sw(torch.tensor(u), torch.tensor(v),
                                        torch.tensor(h), tg, F, CG,
                                        [0.0, 0.4], **kw)
    _equal_tree(again, got)


@pytest.mark.parametrize("name,args", [
    ("grid_1d", (64,)),
    ("plane_wave_1d", (64, 1.0, 1.0, 0.01, 6)),
    ("geostrophic_jump_1d", (64, 10.0, 10.0, 0.01)),
    ("sw1setup_wave", (5, 0.05, 1.0, 4)),
    ("stokes_drift_1d", (0.01, 2, 1.0, 1.0)),
    ("eulerian_mean_1d", (np.linspace(0, 10, 7), 0.01, 2, 1.0, 1.0)),
])
def test_examples_1d_exact(name, args):
    got = getattr(tex1, name)(*args)
    want = getattr(jex1, name)(*args)
    if np.isscalar(want):
        assert got == want
    else:
        _equal_tree(got, want)
