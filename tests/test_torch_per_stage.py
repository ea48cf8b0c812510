"""The per-stage packet path of swraytracing_torch (ops/interp windows,
models/fields.BlendedFlow, the depth terms of models/dispersion, the
adaptive and frozen-coefficient integrators of models/rays, and the
per-stage branch of models/coupled.lockstep_step) against
swraytracing_tpu on the same numpy inputs (CPU, float64)."""

import numpy as np
import jax
import pytest
import torch

from swraytracing_tpu.models import coupled as jcp
from swraytracing_tpu.models import coupled2 as jc2
from swraytracing_tpu.models import fields as jfi
from swraytracing_tpu.models import rays as jra
from swraytracing_tpu.models.dispersion import Dispersion as JDisp
from swraytracing_tpu.ops import interp as jin
from swraytracing_tpu.ops.grid import SpectralGrid as JGrid
from swraytracing_torch.models import coupled as tcp
from swraytracing_torch.models import coupled2 as tc2
from swraytracing_torch.models import fields as tfi
from swraytracing_torch.models import rays as tra
from swraytracing_torch.models.dispersion import Dispersion as TDisp
from swraytracing_torch.ops import interp as tin
from swraytracing_torch.ops.grid import SpectralGrid as TGrid

from torch_parity import (NX, L, to_jax, to_torch, assert_close,
                          assert_equal, smooth_fields)

ATOL = 1e-12
# whole chunks: O(10) packet values through 8 flow steps of FFTs
ATOL_PACKETS = 1e-10
RTOL_QK = 1e-10

JD, TD = JDisp(f=3.0, Cg=1.0), TDisp(f=3.0, Cg=1.0)


def _packets(rng, n=200, nx=NX):
    # positions across the whole domain and past its edges (periodic wrap)
    x = rng.uniform(-L, 2 * L, (2, n))
    k = rng.standard_normal((2, n)) * 4.0
    return x, k


@pytest.mark.parametrize("nf,order,nx,ny", [(6, 2, 32, 32), (2, 2, 16, 24),
                                             (1, 1, 12, 9), (3, 3, 20, 16)])
def test_build_windows_exact(nf, order, nx, ny):
    rng = np.random.default_rng(nf * 10 + order)
    F = rng.standard_normal((nf, nx, ny))
    got = tin.build_windows(to_torch(F), order)
    assert_equal(got, jin.build_windows(to_jax(F), order))
    # a single (nx, ny) field is the nf=1 stack
    assert_equal(tin.build_windows(to_torch(F[0]), order),
                 jin.build_windows(to_jax(F[0]), order))


@pytest.mark.parametrize("order", [1, 2, 3])
def test_interp_windowed_matches_jax_and_stencil(order):
    rng = np.random.default_rng(order)
    F = smooth_fields(rng, 6)
    x, _ = _packets(rng)
    tg, jg = TGrid.square(NX, L), JGrid.square(NX, L)
    W = tin.build_windows(to_torch(F), order)
    got = tin.interp_windowed(W, 6, to_torch(x[0]), to_torch(x[1]), tg, order)
    want = jin.interp_windowed(jin.build_windows(to_jax(F), order), 6,
                               to_jax(x[0]), to_jax(x[1]), jg, order)
    assert_close(got, want, atol=ATOL)
    stencil = tin.interpolate_stack(to_torch(F), to_torch(x[0]),
                                    to_torch(x[1]), tg, order)
    assert_close(got, stencil.numpy(), atol=ATOL)


def _flows(rng, windowed):
    F1, F2 = smooth_fields(rng, 6), smooth_fields(rng, 6)
    tg, jg = TGrid.square(NX, L), JGrid.square(NX, L)
    tf = tfi.BlendedFlow(fields1=to_torch(F1), fields2=to_torch(F2), grid=tg)
    jf = jfi.BlendedFlow(fields1=to_jax(F1), fields2=to_jax(F2), grid=jg)
    if windowed:
        tf, jf = tf.windowed(), jf.windowed()
    return tf, jf


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("alpha", [0.0, 0.375, 1.0])
def test_blended_flow_at_and_velocity(windowed, alpha):
    rng = np.random.default_rng(7)
    tf, jf = _flows(rng, windowed)
    assert (tf.win1 is not None) == windowed
    x, _ = _packets(rng)
    tev = tf.at(to_torch(x[0]), to_torch(x[1]), alpha)
    jev = jf.at(to_jax(x[0]), to_jax(x[1]), alpha)
    for name in tev._fields:
        assert_close(getattr(tev, name), getattr(jev, name), atol=ATOL,
                     err_msg=name)
    tu, tv = tf.velocity_at(to_torch(x[0]), to_torch(x[1]), alpha)
    ju, jv = jf.velocity_at(to_jax(x[0]), to_jax(x[1]), alpha)
    assert_close(tu, ju, atol=ATOL)
    assert_close(tv, jv, atol=ATOL)
    # the windowed blend equals the stencil blend
    if windowed:
        plain = tfi.BlendedFlow(fields1=tf.fields1, fields2=tf.fields2,
                                grid=tf.grid)
        pev = plain.at(to_torch(x[0]), to_torch(x[1]), alpha)
        assert_close(tev.uv, pev.uv.numpy(), atol=ATOL)


def test_gridded_flow_windowed():
    rng = np.random.default_rng(3)
    F = smooth_fields(rng, 6)
    tg, jg = TGrid.square(NX, L), JGrid.square(NX, L)
    tf = tfi.GriddedFlow(fields=to_torch(F), grid=tg).windowed()
    jf = jfi.GriddedFlow(fields=to_jax(F), grid=jg).windowed()
    assert_equal(tf.win, jf.win)
    x, _ = _packets(rng)
    tev = tf.at(to_torch(x[0]), to_torch(x[1]))
    jev = jf.at(to_jax(x[0]), to_jax(x[1]))
    for name in tev._fields:
        assert_close(getattr(tev, name), getattr(jev, name), atol=ATOL)
    stencil = tfi.GriddedFlow(fields=to_torch(F), grid=tg).at(
        to_torch(x[0]), to_torch(x[1]))
    assert_close(tev.v_y, stencil.v_y.numpy(), atol=ATOL)


def test_dispersion_depth_terms():
    rng = np.random.default_rng(11)
    k = rng.standard_normal((2, 64)) * 3.0
    H = 1.0 + 0.2 * rng.standard_normal(64)
    u, v = rng.standard_normal((2, 64))
    assert_close(TD.omega_depth(to_torch(k), to_torch(H)),
                 JD.omega_depth(to_jax(k), to_jax(H)), atol=ATOL)
    assert_close(TD.group_velocity_depth(to_torch(k), to_torch(H)),
                 JD.group_velocity_depth(to_jax(k), to_jax(H)), atol=ATOL)
    for Hin in (None, H):
        got = TD.div_group_velocity(
            to_torch(k), to_torch(u), to_torch(v),
            None if Hin is None else to_torch(Hin))
        want = JD.div_group_velocity(
            to_jax(k), to_jax(u), to_jax(v),
            None if Hin is None else to_jax(Hin))
        for g, w in zip(got, want):
            assert_close(g, w, atol=ATOL)


def _gridded(rng):
    F = smooth_fields(rng, 6)
    return (tfi.GriddedFlow(fields=to_torch(F), grid=TGrid.square(NX, L)),
            jfi.GriddedFlow(fields=to_jax(F), grid=JGrid.square(NX, L)))


def test_rk4_frozen_step():
    rng = np.random.default_rng(5)
    tf, jf = _gridded(rng)
    x, k = _packets(rng)
    got = tra.rk4_frozen_step(to_torch(x), to_torch(k), 0.01, TD, tf)
    want = jra.rk4_frozen_step(to_jax(x), to_jax(k), 0.01, JD, jf)
    for g, w in zip(got, want):
        assert_close(g, w, atol=ATOL)


@pytest.mark.parametrize("with_depth", [False, True])
def test_rk4_xka_step(with_depth):
    rng = np.random.default_rng(6)
    tf, jf = _gridded(rng)
    x, k = _packets(rng)
    a = rng.uniform(0.5, 2.0, x.shape[1])
    H = 1.0 + 0.1 * smooth_fields(rng, 1)[0] if with_depth else None
    got = tra.rk4_xka_step(to_torch(x), to_torch(k), to_torch(a), 0.01, TD,
                           tf, None if H is None else to_torch(H))
    want = jra.rk4_xka_step(to_jax(x), to_jax(k), to_jax(a), 0.01, JD, jf,
                            None if H is None else to_jax(H))
    for g, w in zip(got, want):
        assert_close(g, w, atol=ATOL)


@pytest.mark.parametrize("order", [1, 3])
def test_rk4_xka_step_depth_at_the_flow_order(order, monkeypatch):
    """The port interpolates H with the flow's stencil order (the x-k-a
    kernel reads H beside the velocities, at one order); the JAX step
    interpolates it at its default order 2, so it is held here with its
    interpolation taken at the flow's order too."""
    rng = np.random.default_rng(10 + order)
    F = smooth_fields(rng, 6)
    tf = tfi.GriddedFlow(fields=to_torch(F), grid=TGrid.square(NX, L),
                         order=order)
    jf = jfi.GriddedFlow(fields=to_jax(F), grid=JGrid.square(NX, L),
                         order=order)
    x, k = _packets(rng)
    a = rng.uniform(0.5, 2.0, x.shape[1])
    H = 1.0 + 0.1 * smooth_fields(rng, 1)[0]
    monkeypatch.setattr(jra, "interpolate",
                        lambda *args: jin.interpolate(*args, order=order))
    got = tra.rk4_xka_step(to_torch(x), to_torch(k), to_torch(a), 0.01, TD,
                           tf, to_torch(H))
    want = jra.rk4_xka_step(to_jax(x), to_jax(k), to_jax(a), 0.01, JD, jf,
                            to_jax(H))
    for g, w in zip(got, want):
        assert_close(g, w, atol=ATOL)


@pytest.mark.parametrize("rtol,dt0,max_steps", [(1e-6, None, 200_000),
                                                (1e-9, 1e-4, 200_000),
                                                (1e-10, None, 7)])
def test_rk23_adaptive(rtol, dt0, max_steps):
    rng = np.random.default_rng(8)
    tf, jf = _flows(rng, windowed=False)
    x, k = _packets(rng, n=64)
    got = tra.rk23_adaptive(to_torch(x), to_torch(k), 0.05, TD, tf,
                            rtol=rtol, dt0=dt0, max_steps=max_steps)
    want = jax.jit(lambda xx, kk: jra.rk23_adaptive(
        xx, kk, 0.05, JD, jf, rtol=rtol, dt0=dt0, max_steps=max_steps))(
            to_jax(x), to_jax(k))
    assert (got[3], got[4]) == (int(want[3]), int(want[4]))
    assert got[4] > 1
    if max_steps == 7:
        # budget ran out: t_end is a sum of step sizes, each a float64
        # power of the error norm, which the two libraries round apart
        assert got[4] == 7 and got[2] < 0.05
        assert got[2] == pytest.approx(float(want[2]), rel=1e-12)
    else:
        assert got[2] == float(want[2]) == 0.05          # t_end == T
    assert_close(got[0], want[0], atol=1e-10)
    assert_close(got[1], want[1], atol=1e-10)


# ---------------------------------------------------------------------------
# whole per-stage chunks of both coupled models
# ---------------------------------------------------------------------------

MODELS = {
    "qg1": (jcp.CoupledConfig, jcp.setup_coupled, jcp.run_coupled_chunk,
            tcp.CoupledConfig, tcp.setup_coupled, tcp.run_coupled_chunk),
    "qg2": (jc2.Coupled2Config, jc2.setup_coupled2, jc2.run_coupled2_chunk,
            tc2.Coupled2Config, tc2.setup_coupled2, tc2.run_coupled2_chunk),
}
CHUNK = dict(nx=32, n_packets=64, T_Fr_days=20.0, packet_delay_days=0.05,
             packet_steps_per_save=4)
# stencil: below the default window_min_np; windowed: march off and the
# threshold lowered, so the per-stage path interpolates from windows
BRANCHES = {"stencil": {}, "windowed": dict(fused_march=False,
                                            window_min_np=1)}


@pytest.mark.parametrize("stepper", ["rk23", "rk4", "symplectic"])
@pytest.mark.parametrize("branch", ["stencil", "windowed"])
@pytest.mark.parametrize("model", ["qg1", "qg2"])
def test_per_stage_chunk_matches_jax(model, branch, stepper):
    JCfg, jsetup, jrun, TCfg, tsetup, trun = MODELS[model]
    cfg = dict(CHUNK, stepper=stepper, **BRANCHES[branch])
    jcfg, tcfg = JCfg(**cfg), TCfg(**cfg)
    js, jc = jsetup(jcfg)
    ts, tc = tsetup(tcfg, device="cpu", dtype=torch.float64)
    assert ts.march is None and js.march is None
    jc1, (jpx, jpk, jt) = jax.jit(lambda c: jrun(c, js, jcfg, 2))(jc)
    tc1, (tpx, tpk, tt) = trun(tc, ts, tcfg, 2)
    assert_close(tpx, jpx, atol=ATOL_PACKETS)
    assert_close(tpk, jpk, atol=ATOL_PACKETS)
    assert_close(tt, jt, rtol=1e-14)
    qk = np.asarray(jc1.flow_state.qk)
    assert_close(tc1.flow_state.qk, qk, rtol=RTOL_QK,
                 atol=RTOL_QK * float(np.abs(qk).max()))
    assert tc1.overflow is None and jc1.overflow is None
    windowed = branch == "windowed"
    assert (tc1.prev_win is not None) == windowed
    assert (jc1.prev_win is not None) == windowed
    if windowed:
        assert_close(tc1.prev_win, jc1.prev_win, atol=1e-11)
    # the packets moved once t passed the delay
    assert float((tpx[-1] - tc.packet_x).abs().max()) > 1e-4


def test_per_stage_windowed_equals_stencil_and_step_without_windows():
    """The per-stage path from prebuilt windows gives the stencil path's
    packets; a step from a carry without windows builds both and leaves
    without."""
    base = dict(CHUNK, fused_march=False)
    s1, c1 = tc2.setup_coupled2(tc2.Coupled2Config(**base), device="cpu",
                                dtype=torch.float64)
    wcfg = tc2.Coupled2Config(**base, window_min_np=1)
    s2, c2 = tc2.setup_coupled2(wcfg, device="cpu", dtype=torch.float64)
    a, (px1, _, _) = tc2.run_coupled2_chunk(c1, s1, tc2.Coupled2Config(**base),
                                            2)
    b, (px2, _, _) = tc2.run_coupled2_chunk(c2, s2, wcfg, 2)
    assert a.prev_win is None and b.prev_win is not None
    assert_close(px2, px1.numpy(), atol=1e-12)
    ready = tcp.prepare_carry_windows(c2, False, None, 1)
    assert ready.prev_win.shape == (32 * 32, 36 * 6) and ready.overflow is None
    assert tcp.prepare_carry_windows(ready, False, None, 1) is ready
    assert tcp.prepare_carry_windows(ready, False, None, 10 ** 6).prev_win is None
    bare = tc2.coupled2_flow_packet_step(c2, s2, wcfg)
    assert bare.prev_win is None
    with_win = tc2.coupled2_flow_packet_step(ready, s2, wcfg)
    assert_equal(bare.packet_x, with_win.packet_x.numpy())
    with pytest.raises(ValueError, match="unknown stepper"):
        tcp._substep_fn("euler")
