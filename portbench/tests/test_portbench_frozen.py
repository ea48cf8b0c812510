"""The frozen-snapshot cell (`frozen_512.rays`) at a size the CPU holds,
in float64: a sound run is correct, the control and each fault of
faults_frozen.py are not; the pieces of reference/frozen.py against the
port's; K4's counts; and the reading of its two metrics from a profiled
stretch."""

import math

import pytest
import torch

from conftest import ROOT

from portbench import calibrate, core, faults_frozen, trace
from portbench.counts import rays as counts
from portbench.reference import frozen as ref
from portbench.reference.qg import QG

from swraytracing_torch.models import qg
from swraytracing_torch.models.dispersion import Dispersion
from swraytracing_torch.models.fields import flow_from_qk
from swraytracing_torch.ops import march_rays as mr
from swraytracing_torch.ops import spectral as sp
from swraytracing_torch.ops.grid import SpectralGrid

CELL = "frozen_512.rays"
TINY = {"config": {"dtype": "float64", "nx": 32, "spinup_steps": 200},
        "traffic": {"n_packets": 512, "check": {"within": 3}}}
F64 = torch.float64


def run(seed=2 ** 31 + 99):
    return core.run_cell(ROOT, CELL, seed, 0.2, False, "cpu", 0.0,
                         overrides=TINY)


def test_sound_run_is_correct():
    r = run()
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"setup_s", "packet_steps_per_s"}
    assert set(r["checks"]) == set(core.find_cell(ROOT, CELL)[-1])


def test_control_fails_a_limit():
    limits = core.find_cell(ROOT, CELL)[-1]
    r = calibrate.readings(CELL, 2 ** 31 + 5, 0.2, True, "cpu",
                           overrides=TINY)
    assert all(v <= limits[k] for k, v in r["program"].items()), r
    assert any(v > limits[k] for k, v in r["control"].items()), r


@pytest.mark.parametrize("fault", sorted(faults_frozen.FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    faults_frozen.FAULTS[fault](monkeypatch.setattr)
    r = run()
    assert not r["correct"], r["checks"]


def test_a_program_without_the_kernel_route_cannot_run_the_cell(
        monkeypatch):
    from portbench.modes import frozen as mode
    entry = mode.raytrace_frozen
    monkeypatch.setattr(mode, "raytrace_frozen",
                        lambda *a, **kw: entry(*a, **kw))
    with pytest.raises(RuntimeError, match="no kernel route"):
        core.set_up(ROOT, CELL, 11, "cpu", overrides=TINY)


def test_planted_fault_is_undone():
    from swraytracing_torch.models import frozen
    before = mr.march_rays, frozen._STEPPERS
    with faults_frozen.planted("half"):
        assert (mr.march_rays, frozen._STEPPERS) != before
    assert mr.march_rays is before[0] and frozen._STEPPERS is before[1]


def test_reference_pieces_against_the_port():
    """The spin-up, the six grids and the march of reference/frozen.py
    against the port's CPU path from the same inputs."""
    cfg = dict(core.load_json(ROOT / "portbench/configs/frozen_512.json"),
               nx=32)
    grid = SpectralGrid.square(32, cfg["L"])
    R = QG(cfg, "cpu")
    q0, _, dt = R.initial(7, cfg["U_g"])
    qk0 = qg.initial_q_ring(7, grid, cfg["U_g"], cfg["Kd2"], device="cpu",
                            dtype=F64)
    torch.testing.assert_close(q0, qk0, rtol=1e-13, atol=1e-13)
    qp = qg.QGParams(Kd2=cfg["Kd2"], beta=0.0, r_drag=0.0, dt=dt,
                     filter=sp.exp_filter(grid))
    st = qg.qg_init(qk0)
    for _ in range(30):
        st = qg.qg_step(st, grid, qp)
    qk = ref.spin_up(R, q0, dt, 30)
    torch.testing.assert_close(qk, st.qk, rtol=1e-12, atol=1e-12)
    flow = flow_from_qk(st.qk, grid, cfg["Kd2"])
    G = ref.six_grids(R, st.qk)
    torch.testing.assert_close(G, flow.fields, rtol=1e-13, atol=1e-13)
    g = torch.Generator().manual_seed(3)
    x = 7.0 * torch.rand((2, 300), generator=g, dtype=F64) - 0.5
    k = 6.0 * torch.randn((2, 300), generator=g, dtype=F64)
    ev = flow.at(x[0], x[1])
    torch.testing.assert_close(ref.grids_at(G, x, grid.dx, grid.dy),
                               torch.stack(list(ev)), rtol=0, atol=1e-12)
    disp = Dispersion(f=cfg["f"], Cg=cfg["Cg"])
    xN, kN = mr.march_rays(flow.fields, x, k, grid, disp, 1e-3, 40)
    xs, ks, rows, cons = ref.march(G, x, k, 1e-3, 40, 20, cfg["f"],
                                   cfg["Cg"], grid.dx, grid.dy, 40, 384.0,
                                   block=128)
    torch.testing.assert_close(xs[-1], xN, rtol=0, atol=1e-12)
    torch.testing.assert_close(ks[-1], kN, rtol=0, atol=1e-12)
    assert rows.shape == (2, 41) and int(rows.sum(1).min()) == 300
    om0 = disp.absolute_frequency(k, ev.uv)
    evN = flow.at(xN[0], xN[1])
    want = ((disp.absolute_frequency(kN, evN.uv) - om0).abs()
            / torch.maximum(om0.abs(), disp.omega(k))).max()
    assert math.isclose(float(cons[-1]), float(want), rel_tol=1e-9)


def test_counts_are_the_algorithms():
    """K4's operations at the main shape are chip_smoke.py's (30932992000
    a 50-step call of 2^20 packets), the bytes a hand count of the six
    grids and the packets' state, and neither depends on how a kernel
    splits or orders the march: 50 steps in one call or in five."""
    assert counts.flops_per_packet_step(2) == 590
    assert counts.flops(2, 2 ** 20, 50) == 30932992000
    assert counts.bytes_moved(512, 512, 2 ** 20, 4) == 39845888 == \
        6 * 512 * 512 * 4 + 2 ** 20 * 4 * 4 * 2
    assert counts.flops(2, 2 ** 20, 50) == 5 * counts.flops(2, 2 ** 20, 10)
    bound = counts.bound_s_per_step(2, 512, 512, 2 ** 20, 50, 4)
    assert bound == pytest.approx(30932992000 / 67e12 / 50, rel=1e-15)


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 0, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_rays_metrics_read_the_span_and_the_kernel():
    """rays.device_ms_per_step reads what bench.rays launched (the copy,
    the ordering and K4); kernels.rays_roofline K4 alone, by name."""
    events = [
        _ev("user_annotation", "bench.unit", 0, 300),
        _ev("user_annotation", "bench.rays", 10, 200),
        _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        _ev("kernel", "elementwise_kernel", 20, 4, tid=7, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 30, 1, corr=2),
        _ev("kernel", "void (anonymous namespace)::cell_scatter_kernel"
            "<float>(int const*)", 40, 6, tid=7, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 50, 1, corr=3),
        _ev("kernel", "void (anonymous namespace)::march_rays_kernel"
            "<float, 2>(RayArgs<float>)", 60, 90, tid=7, corr=3),
        _ev("cuda_runtime", "cudaLaunchKernel", 250, 1, corr=4),
        _ev("kernel", "reduce_kernel", 260, 20, tid=7, corr=4),
    ]
    t = trace.read(events, 1, 10)
    rec = {"kind": "forward", "trace": t, "march_bound_s_per_step": 1e-6}

    def metric(name):
        return core.load_module(ROOT / "portbench" / "metrics" /
                                f"{name}.py", name).read
    assert math.isclose(metric("rays.device_ms_per_step")(rec), 1e-3 * 10,
                        rel_tol=1e-9)
    assert math.isclose(metric("kernels.rays_roofline")(rec),
                        100 * 1e-6 / 9e-6, rel_tol=1e-9)
    quiet = dict(rec, trace=trace.read(events[:2] + events[-2:], 1, 10))
    assert metric("rays.device_ms_per_step")(quiet) is None
    assert metric("kernels.rays_roofline")(quiet) is None
    no_k4 = dict(rec, trace=trace.read(events[:6] + events[-2:], 1, 10))
    assert metric("rays.device_ms_per_step")(no_k4) > 0
    with pytest.raises(ValueError, match="march_rays_kernel"):
        metric("kernels.rays_roofline")(no_k4)
    for name in ("rays.device_ms_per_step", "kernels.rays_roofline"):
        assert metric(name)(dict(rec, kind="grad")) is None
