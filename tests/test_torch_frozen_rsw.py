"""The pieces that stand on the RSW solver, against the JAX package on the
same numpy inputs (CPU, float64): frozen.raytrace_rsw_restart (the
raytrace_sw.m workflow) and qg.simulate_qg_particles."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from swraytracing_tpu.ops.grid import SpectralGrid as JGrid
from swraytracing_tpu.models import examples as jex
from swraytracing_tpu.models import frozen as jf
from swraytracing_tpu.models import qg as jq
from swraytracing_tpu.models.dispersion import Dispersion as JDisp
from swraytracing_torch.ops.grid import SpectralGrid as TGrid
from swraytracing_torch.models import frozen as tf
from swraytracing_torch.models import qg as tq
from swraytracing_torch.models.dispersion import Dispersion as TDisp

from torch_parity import assert_close

F, CG = 3.0, 1.0
NX = 32
ATOL_FRAMES = 1e-10


def _packets(n, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, 2 * np.pi, (2, n)),
            2.0 * rng.standard_normal((2, n)),
            rng.uniform(0.5, 1.5, n))


@pytest.mark.parametrize("with_a0", [False, True])
def test_raytrace_rsw_restart_parity(with_a0):
    jg, tg = JGrid.square(NX), TGrid.square(NX)
    (u, v, h), _ = jex.wave_and_geostrophic_spectrum_ic(jg, F, CG)
    x0, k0, a0 = _packets(48)
    a0 = a0 if with_a0 else None
    kw = dict(dt=2e-3, nsteps=40, save_every=10)
    want = jf.raytrace_rsw_restart(
        u, v, h, JDisp(f=F, Cg=CG), jg, jnp.asarray(x0), jnp.asarray(k0),
        None if a0 is None else jnp.asarray(a0), **kw)
    got = tf.raytrace_rsw_restart(u, v, h, TDisp(f=F, Cg=CG), tg, x0, k0,
                                  a0, **kw, device="cpu",
                                  dtype=torch.float64)
    for name, g, w in zip("xkat", got, want):
        assert_close(g, w, atol=ATOL_FRAMES, err_msg=name)
    xs, ks, as_, ts = got
    assert xs.shape == ks.shape == (4, 2, 48) and as_.shape == (4, 48)
    assert ts.dtype == torch.float64
    assert bool(torch.isfinite(as_).all()) and float(as_.min()) > 0


def test_raytrace_rsw_restart_float32_tensors_in():
    tg = TGrid.square(NX)
    (u, v, h), _ = jex.wave_and_geostrophic_spectrum_ic(JGrid.square(NX), F,
                                                        CG)
    x0, k0, _ = _packets(16)
    f32 = dict(device="cpu", dtype=torch.float32)
    xs, ks, as_, ts = tf.raytrace_rsw_restart(
        torch.tensor(u), torch.tensor(v), torch.tensor(h),
        TDisp(f=F, Cg=CG), tg, torch.tensor(x0), torch.tensor(k0),
        dt=2e-3, nsteps=4, save_every=2, **f32)
    assert xs.dtype == ks.dtype == as_.dtype == torch.float32
    ref = tf.raytrace_rsw_restart(u, v, h, TDisp(f=F, Cg=CG), tg, x0, k0,
                                  dt=2e-3, nsteps=4, save_every=2, **f32)
    assert torch.equal(xs, ref[0]) and torch.equal(as_, ref[2])


def test_simulate_qg_particles_parity():
    jg, tg = JGrid.square(NX), TGrid.square(NX)
    qk = tq.initial_q_ring(5, tg, 0.4, 3.0, device="cpu",
                           dtype=torch.float64)
    p = tq.QGParams(Kd2=3.0, dt=2e-3, beta=0.5)
    jp = jq.QGParams(Kd2=3.0, dt=2e-3, beta=0.5)
    xp0, _, _ = _packets(40)
    jst, jx, jxs, jts = jq.simulate_qg_particles(
        jq.qg_init(jnp.asarray(qk.numpy())), jnp.asarray(xp0), jg, jp, 30,
        10)
    st, x, xs, ts = tq.simulate_qg_particles(tq.qg_init(qk),
                                             torch.tensor(xp0), tg, p, 30,
                                             10)
    assert_close(st.qk, jst.qk, atol=1e-14)
    assert_close(x, jx, atol=ATOL_FRAMES)
    assert_close(xs, jxs, atol=ATOL_FRAMES)
    assert_close(ts, jts, atol=1e-13)
    assert xs.shape == (3, 2, 40) and st.step == 30
    assert float((xs[-1] - torch.tensor(xp0)).abs().max()) > 1e-4
