"""Each piece of the plain reference against the port's CPU path, in
float64 at a tiny size (test code: it imports both; the reference itself
imports nothing of the port)."""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (puts the repo root on the path)

from swraytracing_torch.analysis.device_diag import (OmegaHistSpec,
                                                     omega_hist_counts)
from swraytracing_torch.models.coupled import (CoupledConfig,
                                               ring_packet_ics)
from swraytracing_torch.models.coupled2 import (Coupled2Config,
                                                run_coupled2_chunk,
                                                setup_coupled2)
from swraytracing_torch.models.fields import GriddedFlow
from swraytracing_torch.ops import march_window as mw
from swraytracing_torch.ops.grid import SpectralGrid
from swraytracing_torch.parallel.ensemble import (run_ensemble_chunk,
                                                  setup_ensemble)

from portbench.reference import hist, packets, stencil
from portbench.reference.coupled import flow_and_packets
from portbench.reference.qg import QG
from portbench.reference.qg2 import QG2
from portbench.reference.rays import flow_step

F64 = torch.float64
SEED = 2 ** 31 + 12345
QG2_KEYS = dict(L=20.0, f=3.0, Cg=1.0, shear=0.5, r=0.4, nu_tune=0.1,
                alpha=4, beta=0.0, CFL_fraction=0.25)


def two_layer(nx=32, n=512, steps=5):
    cfg = Coupled2Config(nx=nx, n_packets=n, packet_delay_days=0.01,
                         packet_steps_per_save=steps, window_min_np=64,
                         seed=SEED)
    s, c0 = setup_coupled2(cfg, device="cpu", dtype=F64)
    return cfg, s, c0


def test_qg2_start_and_steps():
    cfg, s, c0 = two_layer()
    R = QG2(dict(QG2_KEYS, nx=32), "cpu")
    qk0, U0, dt = R.initial(SEED, cfg.U_g)
    assert dt == pytest.approx(s.dt, rel=1e-14)
    torch.testing.assert_close(qk0, c0.flow_state.qk, rtol=1e-13, atol=1e-15)
    R.set_dt(dt)
    c1, _ = run_coupled2_chunk(c0, s, cfg, 2)
    qk = qk0
    r1 = r2 = torch.zeros_like(qk)
    for n in range(10):
        qk, r1, r2 = R.step(qk, r1, r2, n)
    torch.testing.assert_close(qk, c1.flow_state.qk, rtol=1e-12, atol=1e-15)
    torch.testing.assert_close(R.velocity(qk), c1.prev_fields, rtol=1e-12,
                               atol=1e-14)


def test_qg_start_and_steps():
    cfgs = [CoupledConfig(nx=32, n_packets=128, near_inertial_factor=w0,
                          U_g=ug, packet_delay_days=0.01, r_drag=0.0,
                          forcing_strength=0.0, packet_steps_per_save=4,
                          window_min_np=64, seed=SEED)
            for w0, ug in ((2.0, 0.6), (16.0, 1.0))]
    s, es, c0 = setup_ensemble(cfgs, device="cpu", dtype=F64)
    R = QG(dict(nx=32, L=2 * np.pi, f=3.0, Cg=1.0, beta=0.0, r_drag=0.0,
                forcing_strength=0.0, CFL_fraction=0.05), "cpu")
    ics = [R.initial(SEED, c.U_g) for c in cfgs]
    qk = torch.stack([a[0] for a in ics])
    dts = np.array([a[2] for a in ics])
    np.testing.assert_allclose(dts, es.dt, rtol=1e-14)
    torch.testing.assert_close(qk, c0.flow_state.qk, rtol=1e-13, atol=1e-15)
    c1, _ = run_ensemble_chunk(c0, es.replace(T=[2000.0] * 2), s, cfgs[0], 2)
    r1 = r2 = torch.zeros_like(qk)
    for n in range(8):
        qk, r1, r2 = R.step(qk, r1, r2, np.full(2, n), dts)
    torch.testing.assert_close(qk, c1.flow_state.qk, rtol=1e-12, atol=1e-15)


def test_packets_ring():
    cfg = CoupledConfig(n_packets=100, near_inertial_factor=4.0, seed=SEED)
    x, k = ring_packet_ics(cfg, SpectralGrid.square(32), device="cpu",
                           dtype=F64)
    xr, kr = packets.ring(SEED, 100, 4.0, 3.0, 1.0, 2 * np.pi, "cpu")
    assert torch.equal(x, xr) and torch.equal(k, kr)


def test_stencil_and_rays_against_the_march():
    """The plain stencil on the periodic grid and one flow step of rk23
    substeps against the march's plain version on window rows."""
    cfg, s, c0 = two_layer()
    g = torch.Generator().manual_seed(3)
    G1 = c0.prev_fields
    G2 = G1 + 0.01 * torch.randn(G1.shape, generator=g, dtype=F64)
    x, k = c0.packet_x, c0.packet_k
    spec = s.march
    w1 = mw.build_gather_windows(G1, spec)
    w2 = mw.build_gather_windows(G2, spec)
    oi, oj = mw.packet_cells(x[0], x[1], spec)
    h = 0.3 * s.dt
    out, ov = mw.march_gathered_reference(w1, w2, torch.cat([x, k]), oi, oj,
                                          h, spec)
    assert int(ov.max()) == 0
    xr, kr = flow_step(G1[None], G2[None], x[None], k[None],
                       torch.tensor([h], dtype=F64), spec.n_substeps, cfg.f,
                       cfg.Cg, spec.dx, spec.dy)
    torch.testing.assert_close(xr[0], out[:2], rtol=0, atol=1e-12)
    torch.testing.assert_close(kr[0], out[2:], rtol=0, atol=1e-12)
    u, v = stencil.flow_at(G1[None], x[None, 0], x[None, 1], spec.dx,
                           spec.dy)[:2]
    fe = GriddedFlow(fields=torch.cat([G1, G1, G1]), grid=s.grid).at(x[0], x[1])
    torch.testing.assert_close(u[0], fe.u, rtol=0, atol=1e-13)
    torch.testing.assert_close(v[0], fe.v, rtol=0, atol=1e-13)


def test_histogram():
    g = torch.Generator().manual_seed(4)
    k = 20.0 * torch.randn((3, 2, 4000), generator=g, dtype=F64)
    wmax = [64 * w0 * 3.0 for w0 in (2.0, 4.0, 16.0)]
    spec = OmegaHistSpec(n_bins=400, omega_max=1.0, f=3.0, Cg=1.0,
                         omega_min=3.0, log_bins=True)
    port = omega_hist_counts(k, spec, omega_max=torch.tensor(wmax, dtype=F64))
    assert torch.equal(hist.counts(k, 3.0, 1.0, 400, wmax).double(), port)


def test_lockstep_chunk_with_histograms():
    """The reference's lock-step (flow first, packets in blocks) against
    the port's chunk with its diagnostic, from the same state."""
    cfg, s, c0 = two_layer(n=700)
    spec = OmegaHistSpec(n_bins=40, omega_max=64 * 2.0 * 3.0, f=3.0, Cg=1.0,
                         omega_min=3.0, log_bins=True)
    c1, (hc, _) = run_coupled2_chunk(
        c0, s, cfg, 2, diag_fn=lambda c: omega_hist_counts(c.packet_k, spec))
    R = QG2(dict(QG2_KEYS, nx=32), "cpu")
    qk0, _, dt = R.initial(SEED, cfg.U_g)
    R.set_dt(dt)

    def step(st, i, rnd):
        q, a, b = R.step(*st[:3], st[3], rnd)
        return (q, a, b, st[3] + 1)

    z = torch.zeros_like(qk0)
    st, x, k, rows = flow_and_packets(
        step, lambda q, rnd: R.velocity(q, rnd)[None], (qk0, z, z, 0),
        c0.packet_x[None], c0.packet_k[None], 10, 5,
        lambda i: torch.tensor([dt / 2 if (i + 1) * dt > 0.01 / 3 else 0.0],
                               dtype=F64),
        2, cfg.f, cfg.Cg, R.grid.dx, R.grid.dy, 40, [64 * 2.0 * 3.0],
        block=256)
    torch.testing.assert_close(st[0], c1.flow_state.qk, rtol=1e-12,
                               atol=1e-15)
    torch.testing.assert_close(x[0], c1.packet_x, rtol=0, atol=1e-11)
    torch.testing.assert_close(k[0], c1.packet_k, rtol=0, atol=1e-11)
    assert torch.equal(rows[0].double(), hc)
