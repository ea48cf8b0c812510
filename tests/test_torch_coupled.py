"""The one-layer slice as a whole: swraytracing_torch.models.coupled (+ qg,
convert) against swraytracing_tpu.models.coupled from the same config (CPU,
float64). On the CPU the port's march, transpose and window build run
their plain versions; the JAX side runs its XLA reference forward."""

import numpy as np
import jax
import pytest
import torch

from swraytracing_tpu.models import coupled as jcp
from swraytracing_torch.models import coupled as tcp
from swraytracing_torch.models.qg import QGState
from swraytracing_torch.models.qg2 import QG2State
from swraytracing_torch import convert

from torch_parity import (to_numpy, assert_close, assert_equal,
                          jax_carry_tree)

CFG = dict(nx=32, n_packets=256, window_min_np=1, T_Fr_days=30.0,
           packet_delay_days=0.05, packet_steps_per_save=4)

# Packets: O(10) float64 values through 8 flow steps of FFTs and a few
# thousand multiply-adds each; the flow: spectra of O(1..100).
ATOL_PACKETS = 1e-10
RTOL_QK = 1e-10

_MARCH_FIELDS = ("nx", "ny", "dx", "dy", "f", "Cg", "n_substeps", "stepper",
                 "order", "margin", "nf", "tiles_transposed",
                 "grad_from_interp", "combined_gather", "fused_build")


def _setups(**kw):
    cfg = dict(CFG, **kw)
    js, jc = jcp.setup_coupled(jcp.CoupledConfig(**cfg))
    ts, tc = tcp.setup_coupled(tcp.CoupledConfig(**cfg), device="cpu",
                               dtype=torch.float64)
    return (jcp.CoupledConfig(**cfg), js, jc,
            tcp.CoupledConfig(**cfg), ts, tc)


def _assert_carry_close(tc, jc):
    scale = float(np.abs(np.asarray(jc.flow_state.qk)).max())
    assert_close(tc.packet_x, jc.packet_x, atol=ATOL_PACKETS)
    assert_close(tc.packet_k, jc.packet_k, atol=ATOL_PACKETS)
    for name in ("qk", "rhs_m1", "rhs_m2"):
        assert_close(getattr(tc.flow_state, name),
                     getattr(jc.flow_state, name), rtol=RTOL_QK,
                     atol=RTOL_QK * scale, err_msg=name)
    assert_close(tc.prev_fields, jc.prev_fields, atol=1e-11)
    assert tc.flow_state.step == int(jc.flow_state.step)
    assert tc.flow_state.t == pytest.approx(float(jc.flow_state.t),
                                            rel=1e-14)
    assert int(tc.overflow) == int(jc.overflow)


def test_config_defaults_equal():
    assert tcp.CoupledConfig._fields == jcp.CoupledConfig._fields
    assert tuple(tcp.CoupledConfig()) == tuple(jcp.CoupledConfig())
    assert tcp.CoupledSetup._fields == jcp.CoupledSetup._fields
    assert tcp.CoupledConfig().march_fused_build is False


@pytest.mark.parametrize("kw", [{}, {"march_uv_windows": False,
                                     "march_combined_gather": False,
                                     "stepper": "rk4", "n_substeps": 3,
                                     "march_fused_build": True}])
def test_setup_coupled_equal(kw):
    _, js, jc, _, ts, tc = _setups(**kw)
    # U0 comes out of one FFT-based max-speed evaluation on each side
    assert ts.U0 == pytest.approx(js.U0, rel=1e-13)
    assert ts.dt == pytest.approx(js.dt, rel=1e-13)
    assert ts.T == pytest.approx(js.T, rel=1e-12)
    assert ts.Fr == pytest.approx(js.Fr, rel=1e-13)
    assert (ts.n_steps, ts.packet_delay, ts.packet_step_start) == (
        js.n_steps, js.packet_delay, js.packet_step_start)
    assert ts.grid.shape == js.grid.shape and ts.grid.Lx == js.grid.Lx
    assert tuple(ts.disp) == tuple(js.disp)
    jq, tq = js.qg_params, ts.qg_params
    assert tq.Kd2 == jq.Kd2 == 3.0          # f/Cg, as the reference
    for name in ("beta", "r_drag", "dealias", "reference_quirks"):
        assert getattr(tq, name) == getattr(jq, name), name
    assert tq.dt == pytest.approx(jq.dt, rel=1e-13)
    assert_equal(tq.forcing, jq.forcing)
    assert_equal(tq.filter, jq.filter)
    assert ts.march is not None and js.march is not None
    for name in _MARCH_FIELDS:
        assert getattr(ts.march, name) == getattr(js.march, name), name
    # initial carry
    assert_equal(tc.packet_x, jc.packet_x)
    assert_close(tc.packet_k, jc.packet_k, rtol=1e-15)
    scale = float(np.abs(np.asarray(jc.flow_state.qk)).max())
    assert_close(tc.flow_state.qk, jc.flow_state.qk, rtol=1e-12,
                 atol=1e-12 * scale)
    assert_close(tc.prev_fields, jc.prev_fields, atol=1e-12)
    assert tc.prev_fields.shape[0] == ts.march.nf
    assert tc.prev_win is None and tc.overflow is None
    assert isinstance(tc.flow_state, QGState)
    assert (tc.flow_state.t, tc.flow_state.step) == (0.0, 0)


@pytest.mark.parametrize("stepper", ["rk23", "symplectic"])
@pytest.mark.parametrize("fused_build", [False, True])
def test_run_coupled_chunk_matches_jax(fused_build, stepper):
    jcfg, js, jc, tcfg, ts, tc = _setups(march_fused_build=fused_build,
                                         stepper=stepper)
    assert ts.march.fused_build == fused_build
    n_saves = 2
    jc1, (jpx, jpk, jt) = jax.jit(
        lambda c: jcp.run_coupled_chunk(c, js, jcfg, n_saves))(jc)
    tc1, (tpx, tpk, tt) = tcp.run_coupled_chunk(tc, ts, tcfg, n_saves)
    assert tpx.shape == (n_saves, 2, jcfg.n_packets)
    assert_close(tpx, jpx, atol=ATOL_PACKETS)
    assert_close(tpk, jpk, atol=ATOL_PACKETS)
    assert_close(tt, jt, rtol=1e-14)
    _assert_carry_close(tc1, jc1)
    assert int(tc1.overflow) == 0
    assert tc1.prev_win is not None and tc1.prev_win.shape == (
        32 * 32, ts.march.K)
    assert float((tpx[-1] - tc.packet_x).abs().max()) > 1e-3  # they moved
    assert tc.prev_win is None and tc.flow_state.step == 0  # input untouched


def test_fused_build_changes_no_bit():
    """The one-pass window build hands the march the same windows as the
    two-pass route: the chunks agree bit for bit."""
    _, _, _, acfg, as_, ac = _setups(march_fused_build=True)
    _, _, _, bcfg, bs, bc = _setups(march_fused_build=False)
    a1, (apx, apk, _) = tcp.run_coupled_chunk(ac, as_, acfg, 1)
    b1, (bpx, bpk, _) = tcp.run_coupled_chunk(bc, bs, bcfg, 1)
    assert_equal(apx, to_numpy(bpx))
    assert_equal(apk, to_numpy(bpk))
    assert_equal(a1.prev_win, to_numpy(b1.prev_win))
    assert_equal(a1.flow_state.qk, to_numpy(b1.flow_state.qk))


def test_chunk_from_converted_jax_carry():
    """A JAX run's carry, forcing and filter, pushed through convert, go on
    in the port exactly as they go on in JAX; and back again."""
    jcfg, js, jc, tcfg, ts, _ = _setups(march_fused_build=True)
    run = jax.jit(lambda c: jcp.run_coupled_chunk(c, js, jcfg, 1))
    jc1, _ = run(jc)                       # 4 steps in JAX
    handed = convert.carry_from_numpy(jax_carry_tree(jc1), device="cpu",
                                      dtype=torch.float64)
    assert isinstance(handed.flow_state, QGState)
    assert handed.flow_state.step == 4 and handed.overflow.dtype == torch.int32
    assert_equal(handed.prev_win, jc1.prev_win)
    jq = js.qg_params
    qp = convert.qg_params_from_numpy(
        jq.Kd2, jq.dt, forcing=np.asarray(jq.forcing),
        filter=np.asarray(jq.filter), beta=jq.beta, r_drag=jq.r_drag,
        dealias=jq.dealias, reference_quirks=jq.reference_quirks)
    ts_handed = ts._replace(qg_params=qp, dt=js.dt)
    jc2, (jpx, jpk, _) = run(jc1)          # 4 more in JAX
    tc2, (tpx, tpk, _) = tcp.run_coupled_chunk(handed, ts_handed, tcfg, 1)
    assert_close(tpx, jpx, atol=ATOL_PACKETS)
    assert_close(tpk, jpk, atol=ATOL_PACKETS)
    _assert_carry_close(tc2, jc2)
    # round trip through numpy: the state's rank picks its class
    tree = convert.carry_to_numpy(tc2)
    assert tree["flow_state"]["qk"].ndim == 2
    again = convert.carry_from_numpy(tree, device="cpu", dtype=torch.float64)
    assert isinstance(again.flow_state, QGState)
    assert_equal(again.packet_k, to_numpy(tc2.packet_k))
    assert_equal(again.flow_state.qk, to_numpy(tc2.flow_state.qk))
    assert_equal(again.prev_win, to_numpy(tc2.prev_win))
    assert (again.flow_state.t, again.flow_state.step) == (
        tc2.flow_state.t, tc2.flow_state.step)
    tree["flow_state"] = {k: (np.stack([v, v]) if np.ndim(v) == 2 else v)
                          for k, v in tree["flow_state"].items()}
    assert isinstance(convert.carry_from_numpy(
        tree, device="cpu", dtype=torch.float64).flow_state, QG2State)
    tree["flow_state"]["qk"] = np.zeros(3)
    with pytest.raises(ValueError, match="rank"):
        convert.carry_from_numpy(tree, device="cpu")


def test_run_crosses_packet_delay():
    """Packets are frozen (bit for bit) until t > packet_delay, then move,
    on both sides at the same step."""
    jcfg, js, jc, tcfg, ts, tc = _setups(packet_steps_per_save=1,
                                         march_fused_build=True)
    delay_days = 2.5 * ts.dt * jcfg.f       # between steps 2 and 3
    jcfg = jcfg._replace(packet_delay_days=delay_days)
    tcfg = tcfg._replace(packet_delay_days=delay_days)
    js = js._replace(packet_delay=delay_days / jcfg.f)
    ts = ts._replace(packet_delay=delay_days / tcfg.f)
    _, (jpx, jpk, _) = jax.jit(
        lambda c: jcp.run_coupled_chunk(c, js, jcfg, 5))(jc)
    tc1, (tpx, tpk, tt) = tcp.run_coupled_chunk(tc, ts, tcfg, 5)
    for i in range(2):                      # t = dt, 2 dt: frozen
        assert_equal(tpx[i], to_numpy(tc.packet_x))
        assert_equal(tpk[i], to_numpy(tc.packet_k))
    assert float((tpx[2] - tpx[1]).abs().max()) > 0   # t = 3 dt: moving
    assert_close(tpx, jpx, atol=ATOL_PACKETS)
    assert_close(tpk, jpk, atol=ATOL_PACKETS)
    assert int(tc1.overflow) == 0


def test_diag_fn_replaces_packet_saves():
    jcfg, js, jc, tcfg, ts, tc = _setups()
    c1, (diag, tt) = tcp.run_coupled_chunk(
        tc, ts, tcfg, 2, diag_fn=lambda c: c.packet_k.abs().max(dim=1).values)
    assert diag.shape == (2, 2) and tt.shape == (2,)
    _, (jdiag, jt) = jax.jit(lambda c: jcp.run_coupled_chunk(
        c, js, jcfg, 2,
        diag_fn=lambda cc: jax.numpy.abs(cc.packet_k).max(axis=1)))(jc)
    assert_close(diag, jdiag, atol=ATOL_PACKETS)
    assert_close(tt, jt, rtol=1e-14)
    assert tt[-1] == pytest.approx(c1.flow_state.t)


def test_unported_paths_raise_and_name_their_roadmap_item():
    # below window_min_np the per-stage packet path runs (ported; held
    # against JAX in tests/test_torch_per_stage.py)
    cfg = tcp.CoupledConfig(**dict(CFG, window_min_np=65536))
    s, carry = tcp.setup_coupled(cfg, device="cpu", dtype=torch.float64)
    assert s.march is None and carry.prev_fields.shape[0] == 6
    c1, (px, _, _) = tcp.run_coupled_chunk(carry, s, cfg, 1)
    assert c1.overflow is None and torch.isfinite(px).all()
    assert tcp.coupled_flow_packet_step(carry, s, cfg).prev_win is None
    # remat chunks (ported): the forward is the plain chunk's, bit for
    # bit, and the carry leaves without windows
    _, _, _, tcfg, ts, tc = _setups()
    r1, (rpx, rpk, rt) = tcp.run_coupled_chunk(tc, ts, tcfg, 1, remat=True)
    p1, (ppx, ppk, pt) = tcp.run_coupled_chunk(tc, ts, tcfg, 1)
    assert_equal(rpx, to_numpy(ppx))
    assert_equal(rpk, to_numpy(ppk))
    assert_equal(r1.flow_state.qk, to_numpy(p1.flow_state.qk))
    assert r1.prev_win is None and p1.prev_win is not None
    assert int(r1.overflow) == 0
    with pytest.raises(TypeError, match="remat"):
        tcp.prepare_carry_windows(tc, ts.march)


def test_reference_quirks_config_reaches_the_solver():
    """reference_quirks and dealias travel from the config into the flow
    step (one step: the quirks run is unstable by design)."""
    jcfg, js, jc, tcfg, ts, tc = _setups(reference_quirks=True, dealias=True,
                                         ring_ic=False)
    assert ts.qg_params.reference_quirks and ts.qg_params.dealias
    j1 = jax.jit(lambda c: jcp.coupled_flow_packet_step(
        jcp.prepare_carry_windows(c, False, js.march, 1), js, jcfg))(jc)
    t1 = tcp.coupled_flow_packet_step(
        tcp.prepare_carry_windows(tc, False, ts.march), ts, tcfg)
    _assert_carry_close(t1, j1)
