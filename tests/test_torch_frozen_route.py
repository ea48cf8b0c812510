"""models/frozen.raytrace_frozen's two routes: the march kernel (K4), one
ops/march_rays.march_rays call a frame, for CUDA packets marched by the
symplectic stepper through a GriddedFlow of six grids; the plain
integrators for everything else, bit for bit what they were. Also
raytrace_pv_snapshot's inversion of its frame, and the spans.

The tests marked `card` need a CUDA device and skip without one. This
file imports no JAX, so on a machine with a card it runs on its own:
`python -m pytest tests/test_torch_frozen_route.py --noconftest -q`.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from swraytracing_torch.io import binio
from swraytracing_torch.models import frozen, rays
from swraytracing_torch.models.analytic import childress_soward
from swraytracing_torch.models.dispersion import Dispersion
from swraytracing_torch.models.fields import (BlendedFlow, GriddedFlow,
                                              flow_from_qk)
from swraytracing_torch.models.qg import initial_q_ring
from swraytracing_torch.ops import interp
from swraytracing_torch.ops import march_rays as mr
from swraytracing_torch.ops import spectral as sp
from swraytracing_torch.ops.grid import SpectralGrid
from swraytracing_torch.utils import profiling

DISP = Dispersion(f=3.0, Cg=1.0)
F64 = torch.float64
NX = 64
KD2 = 3.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def snapshot(device="cpu", dtype=F64, nx=NX):
    grid = SpectralGrid.square(nx)
    qk = initial_q_ring(5, grid, 1.0, KD2, device=device, dtype=dtype)
    return flow_from_qk(qk, grid, KD2)


def packets(n, device="cpu", dtype=F64, seed=3):
    return frozen.ring_ics(n, 2.0, DISP, seed=seed, device=device,
                           dtype=dtype)


def before(flow, x0, k0, dt, nsteps, save_every, stepper):
    """raytrace_frozen as it stood before it had a kernel route."""
    if (isinstance(flow, GriddedFlow) and flow.win is None
            and x0.shape[-1] >= interp._WINDOW_MIN_NP):
        flow = flow.windowed()
    step = {"symplectic": rays.symplectic_step, "yoshida4": rays.yoshida4_step,
            "rk4": rays.rk4_step, "rk23": rays.rk23_step}[stepper]
    xs, ks, ts = rays.integrate_rays(
        x0, k0, dt, nsteps, lambda x, k, t: step(x, k, dt, DISP, flow),
        save_every=save_every)

    def abs_at(x, k):
        return DISP.absolute_frequency(k, flow.at(x[0], x[1]).uv)

    n = xs.shape[0]
    empty = x0.new_zeros((0, x0.shape[-1]))
    om = torch.stack([DISP.omega(ks[j]) for j in range(n)]) if n else empty
    om_abs = (torch.stack([abs_at(xs[j], ks[j]) for j in range(n)])
              if n else empty)
    return frozen.FrozenResult(x=xs, k=ks, t=ts, omega=om,
                               omega_abs0=abs_at(x0, k0), omega_abs=om_abs)


def assert_same_bits(got, want):
    for name in frozen.FrozenResult._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape and torch.equal(a, b), name


# -- on the CPU: the plain route, the rule, the inversion, the spans ---------

@pytest.mark.parametrize("stepper", ["symplectic", "yoshida4", "rk4",
                                     "rk23"])
@pytest.mark.parametrize("windowed", [False, True])
def test_plain_route_is_bit_for_bit_what_it_was(stepper, windowed,
                                                monkeypatch):
    if windowed:  # the switch to prebuilt windows, lowered to 16 packets
        monkeypatch.setattr(interp, "_WINDOW_MIN_NP", 16)
    flow = snapshot()
    x0, k0 = packets(40)
    kept = dict(frozen.raytrace_frozen.routes)
    got = frozen.raytrace_frozen(flow, x0, k0, DISP, 0.005, 45, 10, stepper)
    assert_same_bits(got, before(flow, x0, k0, 0.005, 45, 10, stepper))
    assert got.x.shape == (4, 2, 40)
    assert frozen.raytrace_frozen.routes == dict(kept,
                                                 plain=kept["plain"] + 1)


def test_plain_route_analytic_flow_bit_for_bit():
    flow = childress_soward(device="cpu", dtype=F64)
    x0, k0 = packets(30)
    got = frozen.raytrace_frozen(flow, x0, k0, DISP, 0.01, 20, 5)
    assert_same_bits(got, before(flow, x0, k0, 0.01, 20, 5, "symplectic"))


def _like(dtype=torch.float32, cuda=True, shape=(2, 10)):
    """A stand-in for a tensor, for the rule only: it reads nothing but
    the device, the dtype and the shape."""
    device = torch.device("cuda" if cuda else "cpu")
    return SimpleNamespace(is_cuda=cuda, dtype=dtype, device=device,
                           shape=shape)


def test_route_rule():
    grid = SpectralGrid.square(NX)
    flow = GriddedFlow(fields=_like(shape=(6, NX, NX)), grid=grid)
    x, k = _like(), _like()
    assert frozen.frozen_route(flow, x, k, "symplectic") == "kernel"
    f64 = GriddedFlow(fields=_like(F64, shape=(6, NX, NX)), grid=grid)
    assert frozen.frozen_route(f64, _like(F64), _like(F64),
                               "symplectic") == "kernel"
    plain = [
        (flow, x, k, "rk4"), (flow, x, k, "rk23"), (flow, x, k, "yoshida4"),
        (childress_soward(device="cpu", dtype=F64), x, k, "symplectic"),
        (BlendedFlow(fields1=flow.fields, fields2=flow.fields, grid=grid),
         x, k, "symplectic"),
        (dataclasses.replace(flow, order=4), x, k, "symplectic"),
        (flow, _like(cuda=False), k, "symplectic"),
        (flow, _like(torch.float16), _like(torch.float16), "symplectic"),
        (flow, x, _like(F64), "symplectic"),
        (f64, x, k, "symplectic"),
        (GriddedFlow(fields=_like(shape=(2, NX, NX)), grid=grid), x, k,
         "symplectic"),
    ]
    for case in plain:
        assert frozen.frozen_route(*case) == "plain", case


def test_routes_count_every_call():
    flow = snapshot()
    x0, k0 = packets(20)
    kept = dict(frozen.raytrace_frozen.routes)
    for stepper in ("symplectic", "yoshida4", "rk4", "rk23"):
        frozen.raytrace_frozen(flow, x0, k0, DISP, 0.005, 4, 2, stepper)
    frozen.raytrace_frozen(dataclasses.replace(flow, order=3), x0, k0, DISP,
                           0.005, 4, 2)
    assert frozen.raytrace_frozen.routes == {"kernel": kept["kernel"],
                                             "plain": kept["plain"] + 5}


@pytest.mark.parametrize("nsteps, save_every", [(40, 10), (45, 10), (0, 10),
                                                (7, 20)])
def test_kernel_route_frames_on_the_cpu(nsteps, save_every):
    """The kernel route's body on CPU tensors, where march_rays runs its
    plain version: the frames and times of the plain route, bit for bit,
    and its Omega_abs (through the velocity grids alone) to round-off."""
    flow = snapshot()
    x0, k0 = packets(50)
    got = frozen._frozen_kernel(flow, x0, k0, DISP, 0.005, nsteps,
                                save_every)
    want = before(flow, x0, k0, 0.005, nsteps, save_every, "symplectic")
    for name in ("x", "k", "t", "omega"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape and torch.equal(a, b), name
    for name in ("omega_abs0", "omega_abs"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=1e-13)
    assert got.x.shape[0] == nsteps // save_every


def test_pv_snapshot_inverts_the_frame_by_flow_from_qk(tmp_path,
                                                        monkeypatch):
    grid = SpectralGrid.square(32)
    qk = initial_q_ring(3, grid, 0.3, 3.0, device="cpu", dtype=F64)
    q = sp.to_grid(qk, grid).numpy()
    binio.write_field(q, tmp_path / "pv", 1)
    seen = []
    monkeypatch.setattr(frozen, "raytrace_frozen",
                        lambda flow, *a: seen.append(flow))
    frozen.raytrace_pv_snapshot(tmp_path / "pv", frame=1, nx=32, Kd2=3.0,
                                disp=DISP, device="cpu", dtype=F64)
    qk1 = sp.to_spectral(torch.as_tensor(binio.read_field(
        tmp_path / "pv", 32, 32, frames=1), dtype=F64), grid)
    want = flow_from_qk(qk1, grid, 3.0)
    assert torch.equal(seen[0].fields, want.fields)
    assert (seen[0].order, seen[0].win, seen[0].grid) == (2, None, grid)


def test_spans_only_while_open():
    flow = snapshot()
    x0, k0 = packets(20)
    with profiling.spans() as table:
        frozen.raytrace_frozen(flow, x0, k0, DISP, 0.005, 30, 10)
        frozen._frozen_kernel(flow, x0, k0, DISP, 0.005, 30, 10)
    assert {n: r["calls"] for n, r in table.items()} == {
        "swr.frozen": 1, "swr.frozen.diag": 8, "swr.frozen.march": 3}
    with profiling.spans() as after:
        pass
    frozen.raytrace_frozen(flow, x0, k0, DISP, 0.005, 30, 10)
    assert after == {} and profiling._table is None
    assert profiling.span("swr.frozen") is profiling.span("swr.frozen.diag")


# -- on the card: the kernel route against the plain route -------------------

# chip_smoke.py's frozen snapshot (U_g 0.4, K_d^2 3) at 256^2 and the
# cell's dt: segments of 24 steps, so a 45- or 100-step frame is two or
# more launches. float64 to 1e-10 throughout; float32 to chip_smoke's K4
# tolerance, 2e-5, absolute on x and k and relative on omega and
# Omega_abs (O(10), where 2e-5 is ~170 float32 rounding steps)
DT, CARD_NX = 1e-3, 256


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [3000, 2 ** 16 + 37])
@pytest.mark.parametrize("nsteps, save_every", [(40, 10), (45, 20), (0, 10),
                                                (100, 45)])
def test_kernel_route_matches_the_plain_route(card, dtype, n, nsteps,
                                              save_every):
    grid = SpectralGrid.square(CARD_NX)
    flow = flow_from_qk(
        initial_q_ring(146, grid, 0.4, 3.0, device=card, dtype=dtype), grid,
        3.0)
    x0, k0 = packets(n, card, dtype, seed=n)
    kept = dict(frozen.raytrace_frozen.routes)
    launches = mr.march_rays_cuda.launches
    got = frozen.raytrace_frozen(flow, x0, k0, DISP, DT, nsteps, save_every)
    assert frozen.raytrace_frozen.routes == dict(kept,
                                                 kernel=kept["kernel"] + 1)
    segments = mr.split_steps(save_every, mr.segment_steps(DT, grid, DISP))
    assert mr.march_rays_cuda.launches - launches == \
        nsteps // save_every * len(segments)
    want = frozen._frozen_plain(flow, x0, k0, DISP, DT, nsteps, save_every,
                                "symplectic")
    assert torch.equal(got.t, want.t)
    f64 = dtype == torch.float64
    for name in ("x", "k", "omega", "omega_abs0", "omega_abs"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape and a.dtype == dtype and a.is_cuda, name
        xk = name in ("x", "k")
        rtol = 0 if f64 or xk else 2e-5
        atol = 1e-10 if f64 else (2e-5 if xk else 0)
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol, msg=name)
    if nsteps:
        assert float((got.x[-1] - x0).abs().max()) > 1e-2


@pytest.mark.card
def test_kernel_route_spans_on_the_card(card):
    flow = snapshot(card, torch.float32)
    x0, k0 = packets(5000, card, torch.float32)
    with profiling.spans() as table:
        frozen.raytrace_frozen(flow, x0, k0, DISP, DT, 90, 45)
    segments = len(mr.split_steps(45, mr.segment_steps(DT, flow.grid,
                                                       DISP)))
    assert {n: r["calls"] for n, r in table.items()} == {
        "swr.frozen": 1, "swr.frozen.march": 2, "swr.frozen.diag": 3,
        "swr.rays.order": 2 * segments}
    assert np.isfinite(sum(r["ns"] for r in table.values()))
