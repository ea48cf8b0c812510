"""The RSW restart-frame cell (`rsw_512.xka`) at a size the CPU holds, in
float64: a sound run is correct, the control and each fault of
faults_rsw.py are not; the pieces of reference/rsw.py against the port's;
the x-k-a march's counts; the reading of its two metrics from a profiled
stretch; and the reference's imports."""

import ast
import math

import numpy as np
import pytest
import torch

from conftest import ROOT

from portbench import calibrate, core, faults_rsw, trace
from portbench.counts import xka as counts
from portbench.reference import rsw as ref

from swraytracing_torch.models import examples, frozen, rsw
from swraytracing_torch.models.dispersion import Dispersion
from swraytracing_torch.ops import march_rays as mr
from swraytracing_torch.ops.grid import SpectralGrid

CELL = "rsw_512.xka"
TINY = {"config": {"dtype": "float64", "nx": 32, "spinup_steps": 40},
        "traffic": {"n_packets": 384, "check": {"within": 3}}}
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


@pytest.mark.parametrize("fault", sorted(faults_rsw.FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    faults_rsw.FAULTS[fault](monkeypatch.setattr)
    r = run()
    assert not r["correct"], r["checks"]


def test_a_program_without_the_kernel_route_cannot_run_the_cell(
        monkeypatch):
    entry = frozen.raytrace_rsw_restart
    monkeypatch.setattr(frozen, "raytrace_rsw_restart",
                        lambda *a, **kw: entry(*a, **kw))
    with pytest.raises(RuntimeError, match="no kernel route"):
        core.set_up(ROOT, CELL, 11, "cpu", overrides=TINY)


def test_the_mode_calls_the_entry_on_its_module(monkeypatch):
    """A span put in the entry's place (trace.port_spans) is what runs."""
    from portbench.modes import rsw as mode
    seen = []
    entry = frozen.raytrace_rsw_restart

    def spanned(*a, **kw):
        seen.append(1)
        return entry(*a, **kw)
    _, _, _, cell = core.set_up(ROOT, CELL, 12, "cpu", overrides=TINY)
    monkeypatch.setattr(frozen, "raytrace_rsw_restart", spanned)
    cell.unit()
    assert seen == [1] and isinstance(cell, mode.Cell)


def test_planted_fault_is_undone():
    before = mr.march_xka, mr.march_xka_reference
    with faults_rsw.planted("half"):
        assert (mr.march_xka, mr.march_xka_reference) != before
    assert (mr.march_xka, mr.march_xka_reference) == before


CFG = {"nx": 32, "L": 2 * np.pi, "f": 3.0, "Cg": 1.0, "aw": 0.1, "ag": 0.3,
       "k_max_wave": 5, "k_geo_lo": 10, "k_geo_hi": 13,
       "rsw_params": {"hyper_order": 8, "nutune": 1.0, "dttune": 0.1,
                      "dealias": True}}


def test_reference_pieces_against_the_port():
    """The initial state, the swk spin-up, the seven grids and the x-k-a
    march of reference/rsw.py against the port's CPU path."""
    cfg = dict(core.load_json(ROOT / "portbench/configs/rsw_512.json"),
               nx=32)
    grid = SpectralGrid.square(32, cfg["L"])
    seed = 2 ** 40 + 7
    (u, v, h), _ = examples.wave_and_geostrophic_spectrum_ic(
        grid, cfg["f"], cfg["Cg"], cfg["aw"], cfg["ag"], cfg["k_max_wave"],
        cfg["k_geo_lo"], cfg["k_geo_hi"], seed=seed)
    S0 = ref.initial(seed, cfg, "cpu")
    torch.testing.assert_close(S0, torch.as_tensor(np.stack([u, v, h])),
                               rtol=0, atol=1e-14)
    p = rsw.RSWParams(f=cfg["f"], Cg=cfg["Cg"], **cfg["rsw_params"])
    st = rsw.rsw_init(u, v, h, grid, p, device="cpu", dtype=F64)
    _, S, _, _, _ = rsw.simulate_rsw(st, grid, p, 30, 30)
    torch.testing.assert_close(ref.SWK(cfg, "cpu").spin_up(S0, 30), S[-1],
                               rtol=0, atol=1e-13)
    G = frozen.rsw_restart_fields(*S[-1], grid, p)
    torch.testing.assert_close(ref.seven_grids(cfg, S[-1]), G, rtol=0,
                               atol=1e-13)
    disp = Dispersion(f=cfg["f"], Cg=cfg["Cg"])
    x, k = frozen.ring_ics(300, 2.0, disp, seed=5, device="cpu", dtype=F64)
    a = torch.as_tensor(np.random.default_rng(5).uniform(0.5, 1.5, 300))
    xN, kN, aN = mr.march_xka(G, x, k, a, grid, disp, 1e-3, 40)
    xs, ks, as_, rows = ref.march(G, x, k, a, 1e-3, 40, 20, cfg["f"],
                                  cfg["Cg"], grid.dx, grid.dy, 40, 384.0,
                                  block=128)
    torch.testing.assert_close(xs[-1], xN, rtol=0, atol=1e-12)
    torch.testing.assert_close(ks[-1], kN, rtol=0, atol=1e-12)
    torch.testing.assert_close(as_[-1], aN, rtol=1e-12, atol=0)
    assert rows.shape == (2, 41) and int(rows.sum(1).min()) == 300
    assert float((aN - a).abs().max()) > 1e-4


def test_reference_imports_neither_the_port_nor_jax():
    tree = ast.parse((ROOT / "portbench/reference/rsw.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert names and all(n.split(".")[0] not in core.FORBIDDEN
                         + ("swraytracing_torch",) for n in names), names
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_counts_are_the_algorithms():
    """The x-k-a march's operations at the main shape (1561 a packet-step
    at order 2: three velocity evaluations, one of seven grids, the RK4
    arithmetic; one evaluation of three grids a call), the bytes a hand
    count of the seven grids and the packets' x, k and a, neither
    depending on how a kernel splits or orders the march or on the
    kernel's own evaluations."""
    assert counts.evaluation(2, 6) == 548    # K4's stencil (counts/rays)
    assert counts.flops_per_packet_step(2) == 1561
    assert counts.flops(2, 2 ** 20, 50) == (1561 * 50 + 332) * 2 ** 20
    assert counts.bytes_moved(512, 512, 2 ** 20, 4) == \
        7 * 512 * 512 * 4 + 2 ** 20 * 5 * 4 * 2
    bound = counts.bound_s_per_step(2, 512, 512, 2 ** 20, 50, 4)
    assert bound == pytest.approx((1561 * 50 + 332) * 2 ** 20 / 67e12 / 50,
                                  rel=1e-15)
    # more steps a call: the same work a step, up to the call's start
    assert counts.flops(2, 100, 50) - counts.flops(2, 100, 10) == \
        counts.flops_per_packet_step(2) * 100 * 40


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 0, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_xka_metrics_read_the_span_and_the_kernel():
    """xka.device_ms_per_step reads what bench.xka launched (the
    transforms, the copy, the ordering and the kernel);
    kernels.xka_roofline the kernel alone, by name."""
    events = [
        _ev("user_annotation", "bench.unit", 0, 300),
        _ev("user_annotation", "bench.xka", 10, 200),
        _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        _ev("kernel", "regular_fft_factor", 20, 4, tid=7, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 30, 1, corr=2),
        _ev("kernel", "void (anonymous namespace)::cell_scatter_kernel"
            "(int const*)", 40, 6, tid=7, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 50, 1, corr=3),
        _ev("kernel", "void (anonymous namespace)::march_xka_kernel"
            "<float, 2>(XkaArgs<float>)", 60, 90, tid=7, corr=3),
        _ev("cuda_runtime", "cudaLaunchKernel", 250, 1, corr=4),
        _ev("kernel", "reduce_kernel", 260, 20, tid=7, corr=4),
    ]
    t = trace.read(events, 1, 10)
    rec = {"kind": "forward", "trace": t, "march_bound_s_per_step": 1e-6}

    def metric(name):
        return core.load_module(ROOT / "portbench" / "metrics" /
                                f"{name}.py", name).read
    assert math.isclose(metric("xka.device_ms_per_step")(rec), 1e-3 * 10,
                        rel_tol=1e-9)
    assert math.isclose(metric("kernels.xka_roofline")(rec),
                        100 * 1e-6 / 9e-6, rel_tol=1e-9)
    quiet = dict(rec, trace=trace.read(events[:2] + events[-2:], 1, 10))
    assert metric("xka.device_ms_per_step")(quiet) is None
    assert metric("kernels.xka_roofline")(quiet) is None
    no_kernel = dict(rec, trace=trace.read(events[:6] + events[-2:], 1, 10))
    assert metric("xka.device_ms_per_step")(no_kernel) > 0
    with pytest.raises(ValueError, match="march_xka_kernel"):
        metric("kernels.xka_roofline")(no_kernel)
    # K4's reader does not take the x-k-a kernel for its own
    assert metric("kernels.rays_roofline")(rec) is None
    for name in ("xka.device_ms_per_step", "kernels.xka_roofline"):
        assert metric(name)(dict(rec, kind="grad")) is None
