"""The ensemble of swraytracing_torch (parallel/ensemble.py, the member
axis through qg_step, the fields, the lock-step and the batched window-path
kernels' plain versions) against swraytracing_tpu.parallel.ensemble, the
cases of tests/test_parallel.py: the same configs go to both packages (the
port on the CPU in float64, JAX in x64) and the outputs are compared. Also
model time in float32 runs (ROADMAP C2)."""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swraytracing_tpu.models import coupled as jcp
from swraytracing_tpu.parallel import ensemble as jens
from swraytracing_tpu.analysis import device_diag as jdd
from swraytracing_torch import convert
from swraytracing_torch.analysis import device_diag as tdd
from swraytracing_torch.models import coupled as tcp
from swraytracing_torch.models.qg import qg_step
from swraytracing_torch.ops import march_window as mw
from swraytracing_torch.parallel import ensemble as tens

from torch_parity import assert_close, jax_carry_tree, smooth_fields, to_numpy

PORT = dict(device="cpu", dtype=torch.float64)
ATOL_PACKETS = 1e-10
RTOL_QK = 1e-10
W0S, UGS = (2.0, 8.0), (0.3, 0.9)

# tests/test_parallel.py's configurations: the stencil path (8 packets,
# below window_min_np) and the fused march with the ensemble-max margin;
# and the per-stage path from prebuilt windows (march off)
PATHS = {
    "stencil": dict(nx=32, n_packets=8, T_Fr_days=10.0, packet_delay_days=0.1),
    "fused": dict(nx=32, n_packets=64, T_Fr_days=10.0,
                  packet_delay_days=0.05, window_min_np=1),
    "windowed": dict(nx=32, n_packets=64, T_Fr_days=10.0,
                     packet_delay_days=0.05, window_min_np=1,
                     fused_march=False),
}


def _jax_run(cfg, n_saves, T=None, diag_fn=None):
    base = jcp.CoupledConfig(**cfg)
    s, es, cb = jens.setup_ensemble(jens.sweep_configs(base, W0S, UGS))
    if T is not None:
        es = es.replace(T=jnp.asarray(T))
    run = jax.jit(functools.partial(jens.run_ensemble_chunk, s=s, cfg=base,
                                    n_saves=n_saves, diag_fn=diag_fn))
    return s, es, cb, run(cb, es)


def _port_setup(cfg):
    base = tcp.CoupledConfig(**cfg)
    s, es, cb = tens.setup_ensemble(tens.sweep_configs(base, W0S, UGS),
                                    **PORT)
    return base, s, es, cb


@pytest.fixture(scope="module", params=list(PATHS))
def runs(request):
    """Three saves of the four-member sweep on one path, by both packages."""
    cfg = PATHS[request.param]
    js, jes, jcb, (jc, (jpx, jpk, jts)) = _jax_run(cfg, 3)
    base, ts, tes, tcb = _port_setup(cfg)
    tc, (tpx, tpk, tts) = tens.run_ensemble_chunk(tcb, tes, ts, base, 3)
    return request.param, cfg, (js, jes, jc, jpx, jpk, jts), \
        (base, ts, tes, tcb, tc, tpx, tpk, tts)


def test_ensemble_matches_jax(runs):
    path, _, (js, jes, jc, jpx, jpk, jts), (_, ts, tes, _, tc, tpx, tpk,
                                            tts) = runs
    assert (ts.march is None) == (js.march is None) == (path != "fused")
    if path == "fused":
        assert ts.march.margin == js.march.margin
        assert tc.overflow.shape == (4,) and int(tc.overflow.max()) == 0
        assert int(np.max(np.asarray(jc.overflow))) == 0
    else:
        assert tc.overflow is None
    assert (tc.prev_win is not None) == (path != "stencil")
    for name in ("dt", "packet_delay", "T", "U0"):
        np.testing.assert_allclose(getattr(tes, name),
                                   np.asarray(getattr(jes, name)), rtol=1e-14)
    assert tpx.shape == (4, 3, 2, PATHS[path]["n_packets"])
    assert_close(tpx, jpx, atol=ATOL_PACKETS)
    assert_close(tpk, jpk, atol=ATOL_PACKETS)
    assert_close(tts, jts, rtol=1e-14)
    scale = float(np.abs(np.asarray(jc.flow_state.qk)).max())
    for name in ("qk", "rhs_m1", "rhs_m2"):
        assert_close(getattr(tc.flow_state, name),
                     getattr(jc.flow_state, name), rtol=RTOL_QK,
                     atol=RTOL_QK * scale, err_msg=name)
    np.testing.assert_array_equal(tc.flow_state.step,
                                  np.asarray(jc.flow_state.step))
    assert tc.flow_state.t.dtype == np.float64
    assert tc.flow_state.step.dtype == np.int64


def test_ensemble_matches_port_solo_runs(runs):
    """Each member of the ensemble against the port's own single run of its
    config (the ensemble-max margin changes nothing while nothing
    overflows)."""
    _, _, _, (base, _, _, _, tc, tpx, tpk, tts) = runs
    for i, cfg in enumerate(tens.sweep_configs(base, W0S, UGS)):
        s, carry = tcp.setup_coupled(cfg, **PORT)
        carry, (px, pk, ts) = tcp.run_coupled_chunk(carry, s, cfg, 3)
        assert_close(tpx[i], px, atol=1e-12)
        assert_close(tpk[i], pk, atol=1e-12)
        np.testing.assert_array_equal(tts[i].numpy(), ts.numpy())
        assert tc.flow_state.step[i] == carry.flow_state.step


def test_ensemble_from_jax_state_matches_jax(runs):
    """The port started from the JAX package's EnsembleSetup and batched
    carry (convert.ensemble_from_numpy) runs to JAX's result."""
    _, cfg, (js, jes, jc, jpx, jpk, jts), (base, ts, _, tcb, _, _, _,
                                           _) = runs
    _, _, jcb = jens.setup_ensemble(
        jens.sweep_configs(jcp.CoupledConfig(**cfg), W0S, UGS))
    es, cb = convert.ensemble_from_numpy(
        {k: np.asarray(getattr(jes, k)) for k in ("dt", "packet_delay", "T",
                                                  "U0")},
        jax_carry_tree(jcb), **PORT)
    assert isinstance(cb.flow_state.t, np.ndarray)
    assert cb.packet_x.shape == tcb.packet_x.shape
    tc, (tpx, tpk, tts) = tens.run_ensemble_chunk(cb, es, ts, base, 3)
    assert_close(tpx, jpx, atol=ATOL_PACKETS)
    assert_close(tpk, jpk, atol=ATOL_PACKETS)
    back = convert.carry_to_numpy(tc)
    np.testing.assert_array_equal(back["flow_state"]["step"],
                                  np.asarray(jc.flow_state.step))
    assert back["flow_state"]["t"].dtype == np.float64


@pytest.mark.parametrize("log_bins", [False, True], ids=["linear", "log"])
def test_member_histograms_equal_jax(log_bins):
    """Per-member omega histograms, each member with its own scale through
    the member index: (4, 2, 33) counts equal to JAX's exactly."""
    cfg = PATHS["fused"]
    factor = 64.0 if log_bins else 2.0
    wmax = [factor * w0 * 3.0 for w0 in W0S for _ in UGS]
    kw = dict(n_bins=32, omega_max=1.0, f=3.0, Cg=1.0,
              omega_min=3.0 if log_bins else 0.0, log_bins=log_bins)
    jspec, tspec = jdd.OmegaHistSpec(**kw), tdd.OmegaHistSpec(**kw)
    jw = jnp.asarray(wmax)

    def jdiag(c, i):
        return jdd.omega_hist_counts(c.packet_k, jspec, omega_max=jw[i])

    _, _, _, (jc, (jh, jts)) = _jax_run(cfg, 2, diag_fn=jdiag)
    base, ts, tes, tcb = _port_setup(cfg)
    tw = torch.tensor(wmax, dtype=torch.float64)

    def tdiag(c, i):
        return tdd.omega_hist_counts(c.packet_k, tspec, omega_max=tw[i])

    tc, (th, tts) = tens.run_ensemble_chunk(tcb, tes, ts, base, 2,
                                            diag_fn=tdiag)
    assert th.shape == (4, 2, 33)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert (th.sum(-1) == 64).all()
    # each member's row is its own single histogram, exactly
    for e in range(4):
        np.testing.assert_array_equal(
            th[e, -1].numpy(),
            tdd.omega_hist_counts(tc.packet_k[e], tspec,
                                  omega_max=tw[e]).numpy())


@pytest.mark.parametrize("path", ["stencil", "fused"])
def test_member_past_T_stays_frozen(path):
    """A member with T = 0 keeps its PV spectrum, AB history, packets, time
    and step count bit for bit while the others run (tests/test_parallel.py
    ::test_ensemble_freezes_past_T), in both packages alike."""
    cfg = dict(PATHS[path], packet_delay_days=0.01)
    T = np.array([0.0, 1e9, 1e9, 1e9])   # member 0: already done
    _, _, jcb, (jc, (jpx, jpk, jts)) = _jax_run(cfg, 2, T=T)
    base, ts, tes, tcb = _port_setup(cfg)
    tes = tes.replace(T=T)
    tc, (tpx, tpk, tts) = tens.run_ensemble_chunk(tcb, tes, ts, base, 2)
    fs0, fs1 = tcb.flow_state, tc.flow_state
    for name in ("qk", "rhs_m1", "rhs_m2"):
        assert torch.equal(getattr(fs1, name)[0], getattr(fs0, name)[0])
    assert torch.equal(tc.packet_x[0], tcb.packet_x[0])
    assert torch.equal(tc.packet_k[0], tcb.packet_k[0])
    assert torch.equal(tpx[0, -1], tcb.packet_x[0])
    assert torch.equal(tc.prev_fields[0], tcb.prev_fields[0])
    assert fs1.t[0] == 0.0 and fs1.step[0] == 0
    assert (tts[0] == 0.0).all()
    # the others advanced, as in JAX
    assert (fs1.step[1:] == 2 * base.packet_steps_per_save).all()
    assert not torch.equal(fs1.qk[1], fs0.qk[1])
    assert_close(tpx, jpx, atol=ATOL_PACKETS)
    np.testing.assert_array_equal(fs1.step, np.asarray(jc.flow_state.step))
    np.testing.assert_array_equal(np.asarray(jc.flow_state.qk[0]),
                                  np.asarray(jcb.flow_state.qk[0]))


def test_members_at_different_steps_take_their_own_formula():
    """qg_step over members at steps 0, 1, 2 and 7 (an init_from can seed
    such a carry): each member's Euler / AB2 / AB3 update equals its own
    single-member step."""
    base, s, es, cb = _port_setup(PATHS["stencil"])
    rng = np.random.default_rng(3)
    hist = [torch.as_tensor(rng.standard_normal(cb.flow_state.qk.shape)
                            + 1j * rng.standard_normal(cb.flow_state.qk.shape))
            * 1e-2 for _ in range(2)]
    state = dataclasses.replace(cb.flow_state, rhs_m1=hist[0], rhs_m2=hist[1],
                                step=np.array([0, 1, 2, 7]),
                                t=np.array([0.0, 0.5, 1.0, 2.0]))
    dts = np.array([es.dt[0], es.dt[1], 0.0, es.dt[3]])
    out = qg_step(state, s.grid, s.qg_params, dt=dts)
    np.testing.assert_array_equal(out.step, [1, 2, 3, 8])
    np.testing.assert_array_equal(out.t, state.t + dts)
    for e in range(4):
        single = dataclasses.replace(
            state, qk=state.qk[e], rhs_m1=state.rhs_m1[e],
            rhs_m2=state.rhs_m2[e], step=int(state.step[e]),
            t=float(state.t[e]))
        p = dataclasses.replace(s.qg_params, dt=float(dts[e]))
        want = qg_step(single, s.grid, p)
        # the members' transforms are one batched FFT: last bits only
        torch.testing.assert_close(out.qk[e], want.qk, rtol=1e-12,
                                   atol=1e-13 * float(want.qk.abs().max()))


def _kernel_inputs(E=3, n_p=50, nx=16, dtype=torch.float64):
    rng = np.random.default_rng(17)
    L = 2 * np.pi
    dx = L / nx
    spec = mw.MarchSpec(nx=nx, ny=nx, dx=dx, dy=dx, f=3.0, Cg=1.0,
                        n_substeps=2, nf=2, grad_from_interp=True,
                        tiles_transposed=True)
    F = torch.as_tensor(np.stack([smooth_fields(rng, 4, nx)
                                  for _ in range(E)]), dtype=dtype)
    x = torch.as_tensor(rng.uniform(0, L, (E, 2, n_p)), dtype=dtype)
    k = torch.as_tensor(rng.normal(0, 3, (E, 2, n_p)), dtype=dtype)
    return spec, F, x, k, dx


@pytest.mark.parametrize("fused_build", [False, True])
def test_batched_plain_kernels_equal_their_member_loops(fused_build):
    """Each batched plain version equals the single-member plain versions
    member by member, bit for bit; a member at sub_dt = 0 comes back
    unchanged."""
    spec, F, x, k, dx = _kernel_inputs()
    spec = spec._replace(fused_build=fused_build)
    E = F.shape[0]
    F1, F2 = F[:, :2], F[:, 2:]
    W = mw.build_margin_windows(F1, spec)
    assert W.shape == (E, spec.K, 16 * 16)
    for e in range(E):
        assert torch.equal(W[e], mw.build_margin_windows(F1[e], spec))
    T = mw.transpose_batched_reference(W)
    assert torch.equal(mw.transpose_batched(W), T)
    B = mw.build_windows_batched_reference(F1, spec)
    assert torch.equal(mw.build_windows_batched(F1, spec), B)
    assert torch.equal(B, T)
    win1 = mw.build_gather_windows(F1, spec)
    win2 = mw.build_gather_windows(F2, spec)
    oi, oj = mw.packet_cells(x[:, 0], x[:, 1], spec)
    assert oi.shape == (E, x.shape[-1]) and oi.dtype == torch.int32
    xk = torch.cat([x, k], dim=1)
    sub_dt = torch.tensor([0.0, 0.1 * dx, 0.2 * dx], dtype=torch.float64)
    out, ov = mw.march_gathered_batched(win1, win2, xk, oi, oj, sub_dt, spec)
    ref = mw.march_gathered_batched_reference(win1, win2, xk, oi, oj, sub_dt,
                                              spec)
    assert torch.equal(out, ref[0]) and torch.equal(ov, ref[1])
    for e in range(E):
        assert torch.equal(win1[e], mw.build_gather_windows(F1[e], spec))
        ci, cj = mw.packet_cells(x[e, 0], x[e, 1], spec)
        assert torch.equal(ci, oi[e]) and torch.equal(cj, oj[e])
        want, ov_want = mw.march_gathered_reference(
            win1[e], win2[e], xk[e], oi[e], oj[e], float(sub_dt[e]), spec)
        assert torch.equal(out[e], want) and torch.equal(ov[e], ov_want)
    assert torch.equal(out[0], xk[0]) and int(ov.max()) == 0
    assert not torch.equal(out[1], xk[1])


def test_batched_kernel_wrappers_refuse_cpu_tensors():
    """The batched CUDA wrappers launch kernels only: CPU tensors raise,
    nothing is counted and no library is built."""
    from swraytracing_torch import kernels

    spec, F, x, k, dx = _kernel_inputs(E=2)
    win = mw.build_gather_windows(F[:, :2], spec)
    oi, oj = mw.packet_cells(x[:, 0], x[:, 1], spec)
    xk = torch.cat([x, k], dim=1)
    sub_dt = torch.zeros(2, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        mw.march_gathered_batched_cuda(win, win, xk, oi, oj, sub_dt, spec)
    with pytest.raises(ValueError, match="CUDA"):
        mw.transpose_batched_cuda(win)
    with pytest.raises(ValueError, match="CUDA"):
        mw.build_windows_batched_cuda(F, spec)
    with pytest.raises(ValueError, match="float64"):
        mw.march_gathered_batched_cuda(win, win, xk, oi, oj,
                                       sub_dt.float(), spec)
    assert mw.march_gathered_batched_cuda.launches == 0
    assert mw.transpose_batched_cuda.launches == 0
    assert mw.build_windows_batched_cuda.launches == 0
    assert kernels._lib is None


def test_setup_ensemble_shapes_margin_and_device():
    """Shared shapes and uniform march engagement are asserted as in JAX;
    the spec's margin is the members' maximum; no device means CUDA."""
    base = tcp.CoupledConfig(**PATHS["fused"])
    cfgs = tens.sweep_configs(base, W0S, UGS)
    s, es, cb = tens.setup_ensemble(cfgs, **PORT)
    assert s.march.margin == max(tcp.setup_coupled(c, **PORT)[0].march.margin
                                 for c in cfgs)
    assert cb.packet_x.shape == (4, 2, 64)
    assert cb.prev_fields.shape == (4, 2, 32, 32)
    with pytest.raises(AssertionError, match="shapes"):
        tens.setup_ensemble([base, base._replace(nx=16)], **PORT)
    with pytest.raises(AssertionError, match="uniform"):
        tens.setup_ensemble([base, base._replace(window_min_np=65536)],
                            **PORT)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tens.setup_ensemble(cfgs)
    assert tens.sweep_configs.__doc__ and len(tens.sweep_configs()) == 20


def test_float32_model_time_c2():
    """ROADMAP C2: the JAX package keeps t in the state's real type, so in
    float32 it rounds t + dt every step; the port keeps t in float64 on
    the host, single runs and every ensemble member alike. One 20-step
    chunk from t = 1500 (nx=32, U_g=1.0)."""
    kw = dict(nx=32, n_packets=8, U_g=1.0, T_Fr_days=30.0,
              packet_delay_days=0.1, packet_steps_per_save=20)
    t0, n = 1500.0, 20
    with jax.enable_x64(False):
        cfg = jcp.CoupledConfig(**kw)
        s, c = jcp.setup_coupled(cfg)
        assert c.flow_state.qk.dtype == jnp.complex64
        c = c.replace(flow_state=c.flow_state.replace(
            t=jnp.asarray(t0, jnp.float32)))
        c, _ = jcp.run_coupled_chunk(c, s, cfg, 1)
        jt = c.flow_state.t
        assert jt.dtype == jnp.float32
        jdt = s.dt
    exact = t0 + n * jdt
    assert exact - float(jt) > 0.05 * jdt     # 0.106 dt short

    def summed(t, dt):
        for _ in range(n):
            t += dt
        return t

    cfg = tcp.CoupledConfig(**kw)
    s, c = tcp.setup_coupled(cfg, device="cpu", dtype=torch.float32)
    # both take dt from a float32 maximum speed, each through its own FFT
    assert s.dt == pytest.approx(jdt, rel=1e-6)
    c = dataclasses.replace(c, flow_state=dataclasses.replace(c.flow_state,
                                                              t=t0))
    c, (_, _, ts) = tcp.run_coupled_chunk(c, s, cfg, 1)
    assert c.packet_x.dtype == torch.float32
    assert isinstance(c.flow_state.t, float)
    assert c.flow_state.t == summed(t0, s.dt)
    assert c.flow_state.t == pytest.approx(t0 + n * s.dt, rel=1e-15)
    assert ts.dtype == torch.float64 and float(ts[-1]) == c.flow_state.t

    base = tcp.CoupledConfig(**kw)
    s, es, cb = tens.setup_ensemble(tens.sweep_configs(base, (2.0,),
                                                       (0.6, 1.0)),
                                    device="cpu", dtype=torch.float32)
    cb = dataclasses.replace(cb, flow_state=dataclasses.replace(
        cb.flow_state, t=np.full(2, t0)))
    es = es.replace(T=[2 * t0, 2 * t0])   # live from t0 on
    cb, (_, _, ts) = tens.run_ensemble_chunk(cb, es, s, base, 1)
    assert cb.flow_state.qk.dtype == torch.complex64
    assert cb.flow_state.t.dtype == np.float64
    for e in range(2):
        assert cb.flow_state.t[e] == summed(t0, es.dt[e])
        assert cb.flow_state.t[e] == pytest.approx(t0 + n * es.dt[e],
                                                   rel=1e-15)
    np.testing.assert_array_equal(ts[:, -1].numpy(), cb.flow_state.t)
