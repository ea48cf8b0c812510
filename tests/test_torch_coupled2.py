"""The slice as a whole: swraytracing_torch.models.coupled2 (+ coupled,
convert) against swraytracing_tpu.models.coupled2 from the same config
(CPU, float64). On the CPU the port's march and transpose run their plain
versions; the JAX side runs its XLA reference forward."""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from swraytracing_tpu.models import coupled2 as jc2
from swraytracing_torch.models import coupled2 as tc2
from swraytracing_torch.models import coupled as tcp
from swraytracing_torch.models.qg2 import QG2State
from swraytracing_torch.ops import march_window as tmw
from swraytracing_torch import convert

from torch_parity import (to_numpy, assert_close, assert_equal,
                          jax_carry_tree)

CFG = dict(nx=32, n_packets=256, window_min_np=1, T_Fr_days=20.0,
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
    js, jc = jc2.setup_coupled2(jc2.Coupled2Config(**cfg))
    ts, tc = tc2.setup_coupled2(tc2.Coupled2Config(**cfg), device="cpu",
                                dtype=torch.float64)
    return (jc2.Coupled2Config(**cfg), js, jc,
            tc2.Coupled2Config(**cfg), ts, tc)


def _assert_carry_close(tc, jc, qk_scale):
    assert_close(tc.packet_x, jc.packet_x, atol=ATOL_PACKETS)
    assert_close(tc.packet_k, jc.packet_k, atol=ATOL_PACKETS)
    for name in ("qk", "rhs_m1", "rhs_m2"):
        assert_close(getattr(tc.flow_state, name),
                     getattr(jc.flow_state, name), rtol=RTOL_QK,
                     atol=RTOL_QK * qk_scale, err_msg=name)
    assert_close(tc.prev_fields, jc.prev_fields, atol=1e-11)
    assert tc.flow_state.step == int(jc.flow_state.step)
    assert tc.flow_state.t == pytest.approx(float(jc.flow_state.t),
                                            rel=1e-14)
    assert int(tc.overflow) == int(jc.overflow)


def test_config_defaults_equal():
    assert tc2.Coupled2Config._fields == jc2.Coupled2Config._fields
    assert tuple(tc2.Coupled2Config()) == tuple(jc2.Coupled2Config())
    assert tc2.Coupled2Setup._fields == jc2.Coupled2Setup._fields


@pytest.mark.parametrize("kw", [{}, {"march_uv_windows": False,
                                     "march_combined_gather": False,
                                     "stepper": "rk4", "n_substeps": 3}])
def test_setup_coupled2_equal(kw):
    _, js, jc, _, ts, tc = _setups(**kw)
    # U0 comes out of one FFT-based max-speed evaluation on each side
    assert ts.U0 == pytest.approx(js.U0, rel=1e-13)
    assert ts.dt == pytest.approx(js.dt, rel=1e-13)
    assert ts.T == pytest.approx(js.T, rel=1e-12)
    assert ts.Fr == pytest.approx(js.Fr, rel=1e-13)
    assert (ts.n_steps, ts.packet_delay) == (js.n_steps, js.packet_delay)
    assert ts.grid.shape == js.grid.shape and ts.grid.Lx == js.grid.Lx
    assert tuple(ts.disp) == tuple(js.disp)
    assert tuple(ts.params) == tuple(js.params)
    assert ts.march is not None and js.march is not None
    for name in _MARCH_FIELDS:
        assert getattr(ts.march, name) == getattr(js.march, name), name
    for name in ("B", "expLdt", "expL2dt"):
        np.testing.assert_allclose(getattr(ts.ops, name),
                                   getattr(js.ops, name), rtol=1e-12,
                                   atol=1e-300, err_msg=name)
    # initial carry
    assert_equal(tc.packet_x, jc.packet_x)
    assert_close(tc.packet_k, jc.packet_k, rtol=1e-15)
    scale = float(np.abs(np.asarray(jc.flow_state.qk)).max())
    assert_close(tc.flow_state.qk, jc.flow_state.qk, rtol=1e-12,
                 atol=1e-12 * scale)
    assert_close(tc.prev_fields, jc.prev_fields, atol=1e-12)
    assert tc.prev_fields.shape[0] == ts.march.nf
    assert tc.prev_win is None and tc.overflow is None
    assert (tc.flow_state.t, tc.flow_state.step) == (0.0, 0)


def test_run_coupled2_chunk_matches_jax():
    jcfg, js, jc, tcfg, ts, tc = _setups()
    n_saves = 2
    jc1, (jpx, jpk, jt) = jax.jit(
        lambda c: jc2.run_coupled2_chunk(c, js, jcfg, n_saves))(jc)
    tc1, (tpx, tpk, tt) = tc2.run_coupled2_chunk(tc, ts, tcfg, n_saves)
    assert tpx.shape == (n_saves, 2, jcfg.n_packets)
    assert_close(tpx, jpx, atol=ATOL_PACKETS)
    assert_close(tpk, jpk, atol=ATOL_PACKETS)
    assert_close(tt, jt, rtol=1e-14)
    scale = float(np.abs(np.asarray(jc1.flow_state.qk)).max())
    _assert_carry_close(tc1, jc1, scale)
    assert int(tc1.overflow) == 0
    assert tc1.prev_win is not None and tc1.prev_win.shape == (
        32 * 32, ts.march.K)
    assert float((tpx[-1] - tc.packet_x).abs().max()) > 1e-3  # they moved
    assert tc.prev_win is None and tc.flow_state.step == 0  # input untouched


def test_chunk_from_converted_jax_carry():
    """A JAX run's carry, pushed through convert.carry_from_numpy, goes on
    in the port exactly as it goes on in JAX; and back again."""
    jcfg, js, jc, tcfg, ts, _ = _setups(stepper="symplectic")
    run = jax.jit(lambda c: jc2.run_coupled2_chunk(c, js, jcfg, 1))
    jc1, _ = run(jc)                       # 4 steps in JAX
    handed = convert.carry_from_numpy(jax_carry_tree(jc1), device="cpu",
                                      dtype=torch.float64)
    assert isinstance(handed.flow_state, QG2State)
    assert handed.flow_state.step == 4 and handed.overflow.dtype == torch.int32
    assert_equal(handed.prev_win, jc1.prev_win)
    ops = convert.operators_from_numpy(js.ops.B, js.ops.expLdt,
                                       js.ops.expL2dt, js.ops.dt)
    ts_handed = ts._replace(ops=ops, dt=js.dt)
    jc2_, (jpx, jpk, _) = run(jc1)         # 4 more in JAX
    tc2_, (tpx, tpk, _) = tc2.run_coupled2_chunk(handed, ts_handed, tcfg, 1)
    assert_close(tpx, jpx, atol=ATOL_PACKETS)
    assert_close(tpk, jpk, atol=ATOL_PACKETS)
    scale = float(np.abs(np.asarray(jc2_.flow_state.qk)).max())
    _assert_carry_close(tc2_, jc2_, scale)
    # round trip through numpy
    tree = convert.carry_to_numpy(tc2_)
    again = convert.carry_from_numpy(tree, device="cpu", dtype=torch.float64)
    assert_equal(again.packet_k, to_numpy(tc2_.packet_k))
    assert_equal(again.flow_state.qk, to_numpy(tc2_.flow_state.qk))
    assert (again.flow_state.t, again.flow_state.step) == (
        tc2_.flow_state.t, tc2_.flow_state.step)


def test_run_crosses_packet_delay():
    """Packets are frozen (bit for bit) until t > packet_delay, then move,
    on both sides at the same step."""
    jcfg, js, jc, tcfg, ts, tc = _setups(packet_steps_per_save=1)
    delay_days = 2.5 * ts.dt * jcfg.f       # between steps 2 and 3
    jcfg = jcfg._replace(packet_delay_days=delay_days)
    tcfg = tcfg._replace(packet_delay_days=delay_days)
    js = js._replace(packet_delay=delay_days / jcfg.f)
    ts = ts._replace(packet_delay=delay_days / tcfg.f)
    _, (jpx, jpk, _) = jax.jit(
        lambda c: jc2.run_coupled2_chunk(c, js, jcfg, 5))(jc)
    tc1, (tpx, tpk, tt) = tc2.run_coupled2_chunk(tc, ts, tcfg, 5)
    for i in range(2):                      # t = dt, 2 dt: frozen
        assert_equal(tpx[i], to_numpy(tc.packet_x))
        assert_equal(tpk[i], to_numpy(tc.packet_k))
    assert float((tpx[2] - tpx[1]).abs().max()) > 0   # t = 3 dt: moving
    assert_close(tpx, jpx, atol=ATOL_PACKETS)
    assert_close(tpk, jpk, atol=ATOL_PACKETS)
    assert int(tc1.overflow) == 0


def test_diag_fn_replaces_packet_saves():
    _, _, _, tcfg, ts, tc = _setups()
    c1, (diag, tt) = tc2.run_coupled2_chunk(
        tc, ts, tcfg, 2, diag_fn=lambda c: c.packet_k.abs().max(dim=1).values)
    assert diag.shape == (2, 2) and tt.shape == (2,)
    _, (px, pk, _) = tc2.run_coupled2_chunk(tc, ts, tcfg, 2)
    assert_equal(diag[-1], to_numpy(pk[-1].abs().max(dim=1).values))
    assert tt[-1] == pytest.approx(c1.flow_state.t)


def test_unported_paths_raise_and_name_their_roadmap_item():
    # below window_min_np the per-stage packet path runs (ported; held
    # against JAX in tests/test_torch_per_stage.py)
    cfg = tc2.Coupled2Config(**dict(CFG, window_min_np=65536))
    s, carry = tc2.setup_coupled2(cfg, device="cpu", dtype=torch.float64)
    assert s.march is None and carry.prev_fields.shape[0] == 6
    c1, (px, _, _) = tc2.run_coupled2_chunk(carry, s, cfg, 1)
    assert c1.overflow is None and torch.isfinite(px).all()
    assert tc2.coupled2_flow_packet_step(carry, s, cfg).prev_win is None
    # remat chunks (ported): the forward is the plain chunk's, bit for
    # bit, and the carry leaves without windows
    _, _, _, tcfg, ts, tc = _setups()
    r1, (rpx, rpk, rt) = tc2.run_coupled2_chunk(tc, ts, tcfg, 1, remat=True)
    p1, (ppx, ppk, pt) = tc2.run_coupled2_chunk(tc, ts, tcfg, 1)
    assert_equal(rpx, to_numpy(ppx))
    assert_equal(rpk, to_numpy(ppk))
    assert_equal(r1.flow_state.qk, to_numpy(p1.flow_state.qk))
    assert r1.prev_win is None and p1.prev_win is not None
    assert int(r1.overflow) == 0


def test_fused_build_chunk_matches_jax_and_two_pass():
    """march_fused_build=True: the one-pass window build gives the chunk
    the same windows, so the same packets, as the two-pass route and as
    JAX."""
    jcfg, js, jc, tcfg, ts, tc = _setups(march_fused_build=True)
    assert ts.march.fused_build and js.march.fused_build
    _, (jpx, jpk, _) = jax.jit(
        lambda c: jc2.run_coupled2_chunk(c, js, jcfg, 1))(jc)
    tc1, (tpx, tpk, _) = tc2.run_coupled2_chunk(tc, ts, tcfg, 1)
    assert_close(tpx, jpx, atol=ATOL_PACKETS)
    assert_close(tpk, jpk, atol=ATOL_PACKETS)
    _, _, _, pcfg, ps, pc = _setups()
    pc1, (ppx, ppk, _) = tc2.run_coupled2_chunk(pc, ps, pcfg, 1)
    assert_equal(tpx, to_numpy(ppx))
    assert_equal(tpk, to_numpy(ppk))
    assert_equal(tc1.prev_win, to_numpy(pc1.prev_win))
    assert int(tc1.overflow) == 0


def test_prepare_carry_windows_and_mismatched_carry():
    _, _, _, tcfg, ts, tc = _setups()
    ready = tcp.prepare_carry_windows(tc, False, ts.march)
    assert ready.prev_win.shape == (32 * 32, ts.march.K)
    assert int(ready.overflow) == 0 and ready.overflow.dtype == torch.int32
    assert tcp.prepare_carry_windows(ready, False, ts.march) is ready
    stripped = dataclasses.replace(ready, prev_win=None)
    # a step from a carry without windows builds both and stays without
    stepped = tc2.coupled2_flow_packet_step(stripped, ts, tcfg)
    assert stepped.prev_win is None
    with_win = tc2.coupled2_flow_packet_step(ready, ts, tcfg)
    assert_equal(stepped.packet_x, to_numpy(with_win.packet_x))
    # stale windows of another margin are rebuilt
    wide = ts.march._replace(margin=2)
    assert tcp.prepare_carry_windows(ready, False, wide).prev_win.shape == (
        32 * 32, wide.K)
    # a carry built for 6 field grids does not fit the uv-window path
    bad = dataclasses.replace(
        tc, prev_fields=torch.zeros(6, 32, 32, dtype=torch.float64))
    with pytest.raises(ValueError, match="field grids"):
        tc2.coupled2_flow_packet_step(bad, ts, tcfg)


def test_ring_packet_ics_and_march_spec_rules():
    cfg = tc2.Coupled2Config(**CFG)
    grid = tc2.SpectralGrid.square(32, cfg.L)
    x, k = tcp.ring_packet_ics(cfg, grid, device="cpu", dtype=torch.float32)
    assert x.dtype == torch.float32 and x.shape == (2, 256)
    om = torch.sqrt(cfg.f ** 2 + cfg.Cg ** 2 * (k.double() ** 2).sum(0)) / cfg.f
    np.testing.assert_allclose(to_numpy(om), 2.0, rtol=1e-6)
    assert tcp.build_march_spec(cfg._replace(fused_march=False), grid,
                                0.01, 1.0) is None
    assert tcp.build_march_spec(cfg._replace(stepper="yoshida4"), grid,
                                0.01, 1.0) is None
    spec = tcp.build_march_spec(cfg._replace(march_margin=3), grid, 0.01, 1.0)
    assert spec.margin == 3 and spec.tiles_transposed and spec.nf == 2
    assert tcp.march_n_fields(spec) == 2 and tcp.march_n_fields(None) == 6
    assert tcp.window_threshold(cfg) == 1
    assert isinstance(spec, tmw.MarchSpec)
