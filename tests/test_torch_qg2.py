"""swraytracing_torch.models.{qg2, qg, fields, dispersion} against the JAX
package on the same numpy inputs (CPU, float64)."""

import numpy as np
import pytest
import torch

from swraytracing_tpu.ops.grid import SpectralGrid as JGrid
from swraytracing_tpu.models import qg2 as jqg2, qg as jqg
from swraytracing_tpu.models.fields import flow_from_qk as j_flow_from_qk
from swraytracing_tpu.models.dispersion import Dispersion as JDispersion
from swraytracing_torch.ops.grid import SpectralGrid as TGrid
from swraytracing_torch.models import qg2 as tqg2, qg as tqg
from swraytracing_torch.models.fields import flow_from_qk as t_flow_from_qk
from swraytracing_torch.models.dispersion import Dispersion as TDispersion
from swraytracing_torch import convert

from torch_parity import (to_jax, to_torch, to_numpy, assert_close,
                          assert_equal, random_spectrum)

NX = 32
LBOX = 20.0
KD2 = 3.0


def _setup(dt=0.01, **pkw):
    jg, tg = JGrid.square(NX, LBOX), TGrid.square(NX, LBOX)
    jp = jqg2.QG2Params(Kd2=KD2, **pkw)
    tp = tqg2.QG2Params(Kd2=KD2, **pkw)
    return jg, tg, jp, tp, jqg2.build_operators(jg, jp, dt), \
        tqg2.build_operators(tg, tp, dt)


def _qk0(tg, seed=0, amp=30.0):
    """A two-layer PV state with O(1) velocities, as numpy complex128."""
    return amp * random_spectrum(np.random.default_rng(seed), tg, batch=(2,))


@pytest.mark.parametrize("pkw", [{}, {"beta": 0.7, "shear": 0.3, "r": 0.1}])
def test_build_operators_equal(pkw):
    """Both sides build the operators on the host with numpy in float64
    from the same formulas: equal to the last bits (rtol 1e-14 leaves room
    for a differently rounded libm exp)."""
    _, _, _, _, jo, to = _setup(**pkw)
    for name in ("B", "expLdt", "expL2dt"):
        np.testing.assert_allclose(getattr(to, name), getattr(jo, name),
                                   rtol=1e-14, atol=0, err_msg=name)
    assert to.dt == jo.dt
    ot = to.tensors("cpu", torch.float64)
    assert ot is to.tensors("cpu", torch.float64)  # cached device view
    assert_equal(ot.expLdt, jo.expLdt)


def test_operators_from_numpy_round_trip():
    _, tg, _, tp, jo, to = _setup()
    handed = convert.operators_from_numpy(jo.B, jo.expLdt, jo.expL2dt, jo.dt)
    qk = to_torch(_qk0(tg))
    assert_equal(tqg2.qg2_rhs(qk, tg, handed, tp),
                 tqg2.qg2_rhs(qk, tg, to, tp))


def test_qg2_step_five_steps():
    """Euler -> AB2 -> AB3 -> AB3 -> AB3 against JAX. Each step is a few
    FFTs and complex multiplies of O(1..100) values; 5 steps of roundoff
    stay far below rtol 1e-11 of the largest coefficient."""
    jg, tg, jp, tp, jo, to = _setup()
    qk0 = _qk0(tg)
    js = jqg2.qg2_init(to_jax(qk0))
    ts = tqg2.qg2_init(to_torch(qk0))
    assert ts.t == 0.0 and ts.step == 0
    scale = np.abs(qk0).max()
    for n in range(5):
        js = jqg2.qg2_step(js, jg, jo, jp)
        ts = tqg2.qg2_step(ts, tg, to, tp)
        for name in ("qk", "rhs_m1", "rhs_m2"):
            ref = to_numpy(getattr(js, name))
            assert_close(getattr(ts, name), ref, rtol=1e-11,
                         atol=1e-11 * max(scale, np.abs(ref).max()),
                         err_msg=f"{name} after step {n + 1}")
        assert ts.step == int(js.step) == n + 1
        assert ts.t == pytest.approx(float(js.t), rel=1e-15)
    assert not np.allclose(to_numpy(ts.qk), qk0)  # the state did move


def test_qg2_rhs_dealiased_layers():
    """dealias=True: the port's padded product takes the (2, nx, nky)
    layer stack at once; JAX's takes one spectrum at a time, so it is fed
    layer by layer."""
    jg, tg, jp, tp, jo, to = _setup(dealias=True)
    from swraytracing_tpu.ops import spectral as jsp
    qk0 = _qk0(tg)
    got = tqg2.qg2_rhs(to_torch(qk0), tg, to, tp)
    psik = jqg2._mat2(jo.B, to_jax(qk0))
    for layer in range(2):
        want = jsp.dealiased_jacobian(psik[layer], to_jax(qk0[layer]), jg,
                                      dealias=True)
        assert_close(got[layer], want, rtol=1e-11,
                     atol=1e-11 * np.abs(to_numpy(want)).max())


def test_simulate_qg2_frames():
    jg, tg, jp, tp, jo, to = _setup()
    qk0 = _qk0(tg, seed=1)
    js, jqks, jts = jqg2.simulate_qg2(jqg2.qg2_init(to_jax(qk0)), jg, jo, jp,
                                      6, 3)
    ts, tqks, tts = tqg2.simulate_qg2(tqg2.qg2_init(to_torch(qk0)), tg, to,
                                      tp, 6, 3)
    assert tqks.shape == (2, 2) + tg.spectral_shape
    assert_close(tqks, jqks, rtol=1e-11, atol=1e-11 * np.abs(qk0).max())
    assert_close(tts, jts, rtol=1e-15)


@pytest.mark.parametrize("quirk", [False, True])
@pytest.mark.parametrize("n_fields", [2, 6])
def test_top_layer_flow(n_fields, quirk):
    """Velocity (and gradient) grids: one inversion, up to two spectral
    derivatives and one inverse FFT of O(1) values."""
    jg, tg, jp, tp, jo, to = _setup()
    qk0 = _qk0(tg, seed=2)
    got = tqg2.top_layer_flow(to_torch(qk0), tg, to, tp, quirk,
                              n_fields=n_fields).fields
    want = jqg2.top_layer_flow(to_jax(qk0), jg, jo, jp, quirk,
                               n_fields=n_fields).fields
    assert got.shape == (n_fields, NX, NX)
    assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n_fields,shear", [(2, 0.0), (6, 0.25)])
def test_flow_from_qk(n_fields, shear):
    jg, tg = JGrid.square(NX, LBOX), TGrid.square(NX, LBOX)
    qk = _qk0(tg, seed=3)[0]
    got = t_flow_from_qk(to_torch(qk), tg, KD2, shear=shear,
                         n_fields=n_fields).fields
    want = j_flow_from_qk(to_jax(qk), jg, KD2, shear=shear,
                          n_fields=n_fields).fields
    assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_max_speed2_and_max_speed():
    jg, tg, jp, tp, jo, to = _setup()
    qk0 = _qk0(tg, seed=4)
    assert float(tqg2.max_speed2(to_torch(qk0), tg, to, tp)) == pytest.approx(
        float(jqg2.max_speed2(to_jax(qk0), jg, jo, jp)), rel=1e-13)
    assert float(tqg.max_speed(to_torch(qk0[0]), tg, KD2, 0.5)) == \
        pytest.approx(float(jqg.max_speed(to_jax(qk0[0]), jg, KD2, 0.5)),
                      rel=1e-13)


@pytest.mark.parametrize("ring", [True, False])
def test_initial_q2_ring_same_seed(ring):
    """Same int seed -> same numpy phases on both sides; the spectrum is
    assembled on the host identically and normalised by one max-speed
    evaluation (FFT roundoff only)."""
    jg, tg = JGrid.square(NX, LBOX), TGrid.square(NX, LBOX)
    got = tqg2.initial_q2_ring(5, tg, 0.4, KD2, k_min=3, k_max=9, ring=ring,
                               device="cpu", dtype=torch.float64)
    want = jqg2.initial_q2_ring(5, jg, 0.4, KD2, k_min=3, k_max=9, ring=ring)
    assert got.dtype == torch.complex128 and got.shape == (2,) + \
        tg.spectral_shape
    assert_close(got, want, rtol=1e-12,
                 atol=1e-12 * np.abs(to_numpy(want)).max())
    one = tqg.initial_q_ring(7, tg, 0.4, KD2, device="cpu",
                             dtype=torch.float64)
    assert_close(one, jqg.initial_q_ring(7, jg, 0.4, KD2), rtol=1e-12,
                 atol=1e-12 * float(one.abs().max()))


def test_inertial_ring_forcing_equal():
    jg, tg = JGrid.square(NX, 2 * np.pi), TGrid.square(NX, 2 * np.pi)
    got = tqg.inertial_ring_forcing(0.1, tg, 3.0, 1.0)
    assert_equal(got, jqg.inertial_ring_forcing(0.1, jg, 3.0, 1.0))


def test_dispersion():
    k = np.random.default_rng(6).normal(0, 3.0, (2, 50))
    jd, td = JDispersion(f=3.0, Cg=1.5), TDispersion(f=3.0, Cg=1.5)
    assert td.gH == jd.gH
    assert_close(td.omega(to_torch(k)), jd.omega(to_jax(k)), rtol=1e-15)
    assert_close(td.group_velocity(to_torch(k)),
                 jd.group_velocity(to_jax(k)), rtol=1e-15)
