"""swraytracing_torch.models.qg (the one-layer solver) against
swraytracing_tpu.models.qg on the same numpy inputs (CPU, float64)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from swraytracing_tpu.ops.grid import SpectralGrid as JGrid
from swraytracing_tpu.ops import spectral as jsp
from swraytracing_tpu.models import qg as jqg
from swraytracing_torch.ops.grid import SpectralGrid as TGrid
from swraytracing_torch.ops import spectral as tsp
from swraytracing_torch.models import qg as tqg
from swraytracing_torch import convert

from torch_parity import (to_jax, to_torch, to_numpy, assert_close,
                          assert_equal, random_spectrum)

NX = 32
KD2 = 3.0
DT = 2e-3


def _setup(forced=True, **pkw):
    """Grids and parameters of both packages, with the coupled model's
    forcing and filter (host arrays) or without."""
    jg, tg = JGrid.square(NX), TGrid.square(NX)
    forcing = filt = None
    if forced:
        forcing = tqg.inertial_ring_forcing(0.1, tg, 3.0, 1.0)
        filt = tsp.exp_filter(tg)
        assert_equal(filt, jsp.exp_filter(jg))
    jp = jqg.QGParams(
        Kd2=KD2, dt=DT,
        forcing=None if forcing is None else jnp.asarray(forcing),
        filter=None if filt is None else jnp.asarray(filt), **pkw)
    tp = tqg.QGParams(Kd2=KD2, dt=DT, forcing=forcing, filter=filt, **pkw)
    return jg, tg, jp, tp


def _qk0(tg, seed=0, amp=30.0):
    """A PV state with O(1) velocities, as numpy complex128."""
    return amp * random_spectrum(np.random.default_rng(seed), tg)


def test_params_fields_and_cached_device_view():
    _, _, jp, tp = _setup()
    names = [f.name for f in tqg.QGParams.__dataclass_fields__.values()
             if not f.name.startswith("_")]
    assert tuple(names) == jqg.QGParams._fields
    for name in ("Kd2", "beta", "r_drag", "dt", "dealias",
                 "reference_quirks"):
        assert getattr(tqg.QGParams(Kd2=KD2), name) == \
            getattr(jqg.QGParams(Kd2=KD2), name), name
    view = tp.tensors("cpu", torch.float64)
    assert view is tp.tensors("cpu", torch.float64)   # built once
    assert_equal(view.forcing, jp.forcing)
    assert_equal(view.filter, jp.filter)
    assert tp.tensors("cpu", torch.float32).filter.dtype == torch.float32
    bare = tqg.QGParams(Kd2=KD2).tensors("cpu", torch.float64)
    assert bare.forcing is None and bare.filter is None


@pytest.mark.parametrize("dealias", [False, True])
@pytest.mark.parametrize("quirks", [False, True])
@pytest.mark.parametrize("forced", [False, True])
def test_qg_rhs(forced, quirks, dealias):
    """One inversion, a Jacobian of four inverse and one forward FFT, drag
    and forcing, on O(1..100) coefficients."""
    jg, tg, jp, tp = _setup(forced, beta=0.7, reference_quirks=quirks,
                            dealias=dealias)
    qk0 = _qk0(tg)
    got = tqg.qg_rhs(to_torch(qk0), tg, tp)
    want = to_numpy(jqg.qg_rhs(to_jax(qk0), jg, jp))
    assert got.dtype == torch.complex128
    assert_close(got, want, rtol=1e-11, atol=1e-11 * np.abs(want).max())


@pytest.mark.parametrize("dealias", [False, True])
@pytest.mark.parametrize("quirks", [False, True])
def test_qg_step_five_steps(quirks, dealias):
    """Euler -> AB2 -> AB3 -> AB3 -> AB3 with forcing and filter against
    JAX; 5 steps of roundoff stay far below rtol 1e-11 of the largest
    coefficient."""
    jg, tg, jp, tp = _setup(True, beta=0.3, reference_quirks=quirks,
                            dealias=dealias)
    qk0 = _qk0(tg, seed=1)
    js = jqg.qg_init(to_jax(qk0))
    ts = tqg.qg_init(to_torch(qk0))
    assert ts.t == 0.0 and ts.step == 0
    for n in range(5):
        js = jqg.qg_step(js, jg, jp)
        ts = tqg.qg_step(ts, tg, tp)
        for name in ("qk", "rhs_m1", "rhs_m2"):
            ref = to_numpy(getattr(js, name))
            assert_close(getattr(ts, name), ref, rtol=1e-11,
                         atol=1e-11 * max(np.abs(qk0).max(),
                                          np.abs(ref).max()),
                         err_msg=f"{name} after step {n + 1}")
        assert ts.step == int(js.step) == n + 1
        assert ts.t == pytest.approx(float(js.t), rel=1e-15)
    assert not np.allclose(to_numpy(ts.qk), qk0)  # the state did move
    # the filter did cut the high modes the unfiltered step keeps
    hi = tsp.exp_filter(tg) < 1e-6
    assert np.abs(to_numpy(ts.qk)[hi]).max() < 1e-5 * np.abs(qk0).max()


def test_qg_step_without_filter_or_forcing():
    jg, tg, jp, tp = _setup(False)
    qk0 = _qk0(tg, seed=2)
    js, ts = jqg.qg_init(to_jax(qk0)), tqg.qg_init(to_torch(qk0))
    for _ in range(3):
        js, ts = jqg.qg_step(js, jg, jp), tqg.qg_step(ts, tg, tp)
    assert_close(ts.qk, js.qk, rtol=1e-11, atol=1e-11 * np.abs(qk0).max())


def test_simulate_qg_frames():
    jg, tg, jp, tp = _setup()
    qk0 = _qk0(tg, seed=3)
    js, jqks, jts = jqg.simulate_qg(jqg.qg_init(to_jax(qk0)), jg, jp, 6, 3)
    ts, tqks, tts = tqg.simulate_qg(tqg.qg_init(to_torch(qk0)), tg, tp, 6, 3)
    assert tqks.shape == (2,) + tg.spectral_shape and ts.step == 6
    assert_close(tqks, jqks, rtol=1e-11, atol=1e-11 * np.abs(qk0).max())
    assert_close(tts, jts, rtol=1e-15)
    _, none, nots = tqg.simulate_qg(ts, tg, tp, 0)
    assert none.shape == (0,) + tg.spectral_shape and nots.shape == (0,)


def test_qg_params_from_numpy_carries_a_jax_runs_arrays():
    """The JAX run's forcing and filter, handed over as numpy, step the
    port exactly as the port's own."""
    jg, tg, jp, tp = _setup(beta=0.2, r_drag=0.05)
    handed = convert.qg_params_from_numpy(
        jp.Kd2, jp.dt, forcing=np.asarray(jp.forcing),
        filter=np.asarray(jp.filter), beta=jp.beta, r_drag=jp.r_drag)
    assert handed.forcing.dtype == np.float64
    qk0 = to_torch(_qk0(tg, seed=4))
    a = tqg.qg_step(tqg.qg_init(qk0), tg, handed)
    b = tqg.qg_step(tqg.qg_init(qk0), tg, tp)
    assert_equal(a.qk, to_numpy(b.qk))
    bare = convert.qg_params_from_numpy(KD2, DT)
    assert bare.forcing is None and bare.filter is None
